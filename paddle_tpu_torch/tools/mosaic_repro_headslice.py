"""Head-slice repro: a kernel that reads one head's (s, d) slice straight out
of a (batch, seq, heads, head_dim) tensor, on a hand-written Hopper kernel.

    python3 -m paddle_tpu_torch.tools.mosaic_repro_headslice [--seed N]

Port of `tools/mosaic_repro_headslice.py`. The no-relayout flash variant
wants to consume attention tensors in their native (b, s, n, d) layout, a
(batch, head) program cutting a (1, s, 1, d) block out of the middle dim and
using it as an (s, d) matrix. Mosaic could not lower that squeeze, which is
why the flash kernels take (b * n, s, d) copies (`ops/flash_attention.py`
`_to_bn`). Its TPU kernel `kern` (:34) becomes the CUDA C++ kernel
`ops/csrc/headslice_gram.cu`, which reads the slice through x's strides:

  `kern` (:34) -> `headslice_gram`

It returns what the TPU kernel leaves: the Gram matrix `mat @ mat.T` of the
last head's slice, (b, s, s) f32 (the TPU's output block map ignores the
head, so each head's program overwrites the last; here only head n - 1 is
computed). The wrapper runs the kernel on CUDA tensors (adding one to its
`launches` count) and the plain version `headslice_gram_plain`, the JAX
repro's reference einsum, on CPU tensors; anything else raises.

`main()` runs the repro's shape (b 4, s 128, n 12, d 64, f32) on the card
and prints OK when the kernel, reading the slice in place, matches the plain
version within 2e-5 + 2e-5 relative; otherwise it exits non-zero (the JAX
repro prints and exits 0 either way; on CUDA the slice is only strides, so
here a mismatch is a fault).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops.cuda_build import launch, on_cuda

__all__ = ["SHAPE", "TOL", "headslice_gram", "headslice_gram_plain",
           "prepared_launch", "gram_bound", "check", "run", "main"]

SHAPE = (4, 128, 12, 64)    # (b, s, n, d) of the JAX repro
TOL = 2e-5                  # atol and rtol, f32 sums over d in other orders
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12     # H100 SXM fp32 outside the tensor cores


def headslice_gram_plain(x):
    """The JAX repro's reference: einsum("bqd,bkd->bqk") of the last head's
    slice x[:, :, -1], in f32."""
    xs = x[:, :, -1].float()
    return torch.einsum("bqd,bkd->bqk", xs, xs)


def _args(x):
    """The kernel's checks and allocation: ([x, out], [b, s, n, d, strides
    (elements)..., head], their C integer types)."""
    name = "headslice_gram"
    if x.dtype != torch.float32 or x.ndim != 4 or min(x.shape) < 1:
        raise ValueError(f"{name}: x must be a float32 (b, s, n, d) tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    b, s, n, d = x.shape
    out = torch.empty((b, s, s), dtype=torch.float32, device=x.device)
    return ([x, out], [b, s, n, d, *x.stride(), n - 1], "iiiiqqqqi")


def _run(tensors, ints, int_types):
    """Launch on checked inputs and an allocated output, and count it."""
    launch("headslice_gram", tensors, ints, int_types)
    headslice_gram.launches += 1


def headslice_gram(x):
    """mat @ mat.T of x[:, :, n - 1] for each batch, read through x's strides
    (replaces `kern`). x: (b, s, n, d) f32, any strides. Returns (b, s, s)
    f32."""
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
    """(ms, bound_by, FLOPs, bytes): one head's slice read and the (b, s, s)
    result written, 2 * b * s^2 * d FLOPs at the fp32 peak."""
    flops, nbytes = 2.0 * b * s * s * d, 4 * (b * s * d + b * s * s)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def check(shape, seed):
    """The kernel against the plain version on x ~ U(0, 1) of `shape` on
    the card, as the repro draws it: (ok, max abs err)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.rand(shape, generator=gen, device="cuda")
    got = headslice_gram(x)
    torch.cuda.synchronize()
    want = headslice_gram_plain(x)
    diff = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= TOL + TOL * want.abs()).all())
    return ok, diff.max().item()


def run(seed=0):
    """The repro on the card: prints its result line, and OK when the kernel
    matches the plain version. Returns (ok, max abs err)."""
    ok, err = check(SHAPE, seed)
    print(json.dumps({"phase": "headslice", "shape": list(SHAPE),
                      "max_abs_err": err, "tol": TOL, "ok": ok}),
          flush=True)
    if ok:
        print("OK: the kernel reads the interior head slice in place; a "
              "no-relayout flash variant can drop the (b*n, s, d) copies",
              flush=True)
    return ok, err


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mosaic_repro_headslice: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    ok, err = run(args.seed)
    if not ok:
        print(f"headslice_gram differs from the reference by {err}",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
