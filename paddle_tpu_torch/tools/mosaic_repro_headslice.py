"""Head-slice repro: a kernel that reads one head's (s, d) slice straight out
of a (batch, seq, heads, head_dim) tensor, on a hand-written Hopper kernel.

    python3 -m paddle_tpu_torch.tools.mosaic_repro_headslice [--seed N]

Port of `tools/mosaic_repro_headslice.py`. The no-relayout flash variant
wants to consume attention tensors in their native (b, s, n, d) layout, a
(batch, head) program cutting a (1, s, 1, d) block out of the middle dim and
using it as an (s, d) matrix. Mosaic could not lower that squeeze, which is
why the flash kernels take (b * n, s, d) copies (`ops/flash_attention.py`
`_to_bn`). Its TPU kernel `kern` (:34) becomes the CUDA C++ kernel
`ops/csrc/headslice_gram.cu`, which reads the slice through x's strides,
on the tensor cores through a TMA tensor map of x's four dims whose box is
one head wide (the repro's BlockSpec in hardware):

  `kern` (:34) -> `headslice_gram`

It returns what the TPU kernel leaves: the Gram matrix `mat @ mat.T` of the
last head's slice, (b, s, s) f32 (the TPU's output block map ignores the
head, so each head's program overwrites the last; here only head n - 1 is
computed). The wrapper runs the kernel on CUDA tensors (adding one to its
`launches` count) and the plain version `headslice_gram_plain`, the JAX
repro's reference einsum, on CPU tensors; anything else raises.

The library holds two bodies and picks one by a stated rule (`route`, the
twin of the library's): the tensor-core body (split TF32 on wgmma, TMA
loads and stores, tiles ti <= tj stored with their transposes) where TMA
can address x and the output: x 16-byte aligned, an inner stride of 1, the
other strides positive multiples of 4 elements, s a multiple of 4 and d <=
224; else the SIMT body. Either way the launch is counted; a CUDA tensor
never takes the plain version.

`main()` runs the repro's shape (b 4, s 128, n 12, d 64, f32) and the
attention tensors of GPT-2's s1024 b2 cells (2, 1024, 12, 64) on the card
and prints OK when the kernel, reading the slice in place, matches the
plain version within 2e-5 + 2e-5 relative and is bitwise symmetric;
otherwise it exits non-zero (the JAX repro prints and exits 0 either way; on
CUDA the slice is only strides, so here a mismatch is a fault). The
kernel's times at both shapes are `chip_smoke.py`'s times phase.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops.cuda_build import config, launch, on_cuda

__all__ = ["SHAPE", "GPT_SHAPE", "TOL", "headslice_gram",
           "headslice_gram_plain", "route", "tile_walk", "gram_config",
           "prepared_launch", "gram_bound", "check", "run", "main"]

SHAPE = (4, 128, 12, 64)        # (b, s, n, d) of the JAX repro
GPT_SHAPE = (2, 1024, 12, 64)   # GPT-2's attention tensors, s1024 b2 cells
TOL = 2e-5                  # atol and rtol, f32 sums over d in other orders
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12     # H100 SXM fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12    # H100 SXM TF32 tensor cores, dense

# the twin of the library's routing rule and tile walk
# (csrc/headslice_gram.cu `route`, `headslice_gram_kernel_tc`)
TC_TILE = 64                # tensor-core body: 64 x 64 tiles, ti <= tj
TC_MAX_D = 224              # four panels in a block's shared memory
BODIES = ("simt", "tc")     # the library's body numbers


def headslice_gram_plain(x):
    """The JAX repro's reference: einsum("bqd,bkd->bqk") of the last head's
    slice x[:, :, -1], in f32."""
    xs = x[:, :, -1].float()
    return torch.einsum("bqd,bkd->bqk", xs, xs)


def route(b, s, n, d, strides, misalign):
    """The body the library launches for x (b, s, n, d) at `strides`
    (elements) whose address % 16 is `misalign`: "tc" where TMA can address
    the slice and the output, else "simt"."""
    sb, ss, sn, sd = strides
    tma = (misalign == 0 and sd == 1 and s % 4 == 0 and d <= TC_MAX_D
           and all(v > 0 and v % 4 == 0 for v in (sb, ss, sn)))
    return "tc" if tma else "simt"


def tile_walk(b, s):
    """The tensor-core body's blocks in order: block k computes tile
    (ti, tj), ti <= tj, of batch `batch`, batch-major and row-major over
    the upper triangle. [(batch, ti, tj), ...]."""
    nt = -(-s // TC_TILE)
    return [(batch, ti, tj) for batch in range(b)
            for ti in range(nt) for tj in range(ti, nt)]


def _check(x):
    if x.dtype != torch.float32 or x.ndim != 4 or min(x.shape) < 1:
        raise ValueError(f"headslice_gram: x must be a float32 (b, s, n, d) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")


def _args(x):
    """The kernel's checks and allocation: ([x, out], [b, s, n, d, strides
    (elements)..., head], their C integer types)."""
    _check(x)
    b, s, n, d = x.shape
    out = torch.empty((b, s, s), dtype=torch.float32, device=x.device)
    return ([x, out], [b, s, n, d, *x.stride(), n - 1], "iiiiqqqqi")


def gram_config(x):
    """The library's launch for the CUDA tensor x: body, tile, tiles, grid,
    blocks an SM, the block's dynamic shared memory and the waves (grid
    over SMs times blocks an SM)."""
    _check(x)
    dev = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, s, n, d = x.shape
    out = config("headslice_gram", (b, s, n, d, *x.stride(),
                                    x.data_ptr() % 16, sms), 6, dev,
                 "iiiiqqqqii")
    cfg = dict(zip(("body", "tile", "tiles", "grid", "blocks_per_sm",
                    "smem_bytes"), out))
    cfg["body"] = BODIES[cfg["body"]]
    cfg["waves"] = cfg["grid"] / (sms * cfg["blocks_per_sm"])
    return cfg


def _run(tensors, ints, int_types):
    """Launch on checked inputs and an allocated output, and count it."""
    launch("headslice_gram", tensors, ints, int_types)
    headslice_gram.launches += 1


def headslice_gram(x):
    """mat @ mat.T of x[:, :, n - 1] for each batch, read through x's strides
    (replaces `kern`). x: (b, s, n, d) f32, any strides. Returns (b, s, s)
    f32. On a CUDA tensor the library picks its body by `route`."""
    if not on_cuda("headslice_gram", x):
        return headslice_gram_plain(x)
    tensors, ints, types = _args(x)
    _run(tensors, ints, types)
    return tensors[1]


headslice_gram.launches = 0


def prepared_launch(x):
    """A zero-argument launch through `_run` on an input checked and an
    output allocated once, counted as a launch."""
    args = _args(x)
    return lambda: _run(*args)


def gram_bound(b, s, d):
    """(ms, bound_by, FLOPs, bytes, bounds): one head's slice read and the
    (b, s, s) result written, 2 * b * s^2 * d FLOPs. `bounds` holds the
    bytes bound, the fp32 FMA bound (67 TFLOP/s) and the split TF32 bound
    (three products at 495 TFLOP/s), in ms; the least time the card could
    take, `ms`, is the larger of the bytes and split TF32 bounds."""
    flops, nbytes = 2.0 * b * s * s * d, 4 * (b * s * d + b * s * s)
    bounds = {"bytes_ms": nbytes / PEAK_BYTES * 1e3,
              "fp32_ms": flops / PEAK_FP32_FLOPS * 1e3,
              "tf32x3_ms": 3 * flops / PEAK_TF32_FLOPS * 1e3}
    by_bytes = bounds["bytes_ms"] >= bounds["tf32x3_ms"]
    ms = bounds["bytes_ms"] if by_bytes else bounds["tf32x3_ms"]
    return (ms, "bytes" if by_bytes else "operations", flops, nbytes,
            bounds)


def check(shape, seed):
    """The kernel against the plain version on x ~ U(0, 1) of `shape` on
    the card, as the repro draws it: (ok, max abs err); ok also needs the
    result bitwise symmetric."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.rand(shape, generator=gen, device="cuda")
    got = headslice_gram(x)
    torch.cuda.synchronize()
    want = headslice_gram_plain(x)
    diff = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= TOL + TOL * want.abs()).all()) and torch.equal(
        got, got.transpose(1, 2))
    return ok, diff.max().item()


def run(seed=0):
    """The repro on the card at its shape and at GPT-2's: prints a result
    line for each, and OK when the kernel matches the plain version at
    both. Returns (ok, max abs err, the kernel's launches at each
    shape)."""
    oks, errs, launches = [], [], []
    for shape in (SHAPE, GPT_SHAPE):
        before = headslice_gram.launches
        ok, err = check(shape, seed)
        launches.append(headslice_gram.launches - before)
        print(json.dumps({"phase": "headslice", "shape": list(shape),
                          "max_abs_err": err, "tol": TOL, "ok": ok,
                          "launches": launches[-1]}), flush=True)
        oks.append(ok)
        errs.append(err)
    ok = all(oks)
    if ok:
        print("OK: the kernel reads the interior head slice in place; a "
              "no-relayout flash variant can drop the (b*n, s, d) copies",
              flush=True)
    return ok, max(errs), launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mosaic_repro_headslice: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    ok, err, _ = run(args.seed)
    if not ok:
        print(f"headslice_gram differs from the reference by {err}",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
