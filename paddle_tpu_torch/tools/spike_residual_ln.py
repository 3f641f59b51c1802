"""Spike: fused residual-add + LayerNorm (forward + recompute-backward) on two
hand-written Hopper kernels, against the plain composition.

    python3 -m paddle_tpu_torch.tools.spike_residual_ln [--seed N]

Port of `tools/spike_residual_ln.py`. BERT's encoder tail
`x = LN(x + sublayer_out)` at BERT-base shapes is a memory-bound mix of an
elementwise add and two row reductions. The fused schedule computes
s = x + r and the normalised output in one pass, saving only the per-row
(mu, rstd); the backward recomputes s from x + r instead of reading a saved
activation. Its two TPU kernels become CUDA C++ kernels for sm_90a
(`ops/csrc/residual_ln_fwd.cu`, `residual_ln_bwd.cu`), built at first use
and bound with ctypes:

  `fwd_kernel` (:44) -> `residual_ln_fwd`
  `bwd_kernel` (:55) -> `residual_ln_bwd`

Each wrapper runs its kernel on CUDA tensors (checking device, dtype, shape
and contiguity, raising if the launch is refused, and adding one to its
`launches` count) and its plain version (`<name>_plain`) on CPU tensors;
anything else raises. `fused_ln` is the JAX custom_vjp (:82-150) as a
torch.autograd.Function; `torch_ln` the plain composition (JAX `xla_ln`,
:154). No program calls them: the spike is its own entry point, as in the
JAX package.

`main()` prints the spike's table on the card at the JAX spike's four
shapes, in bf16: fused_ln forward and forward+backward (through autograd,
as the JAX spike times jax.grad), the kernels alone (launched on
inputs checked and outputs allocated once),
torch_ln with autograd (the spike's own comparison), F.layer_norm(x + r) as
a library yardstick (timed only), and each direction's bound, its bytes
over the H100's 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from ..ops.cuda_build import config, launch, on_cuda

__all__ = ["EPS", "residual_ln_fwd", "residual_ln_bwd",
           "residual_ln_fwd_plain", "residual_ln_bwd_plain", "fused_ln",
           "torch_ln", "bwd_blocks", "prepared_launches", "SHAPES",
           "main"]

EPS = 1e-5
_MAX_H = 2048            # pair loads, 32 pairs a lane at most (csrc)
_MAX_H_ODD = 1023        # single loads for odd H
PEAK_BYTES = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)

# (M, H) of the JAX spike: BERT-base b128 s128, b64 s128, b256 s512, and
# hidden 1024 at b128 s128
SHAPES = [(128 * 128, 768), (64 * 128, 768), (256 * 512, 768),
          (128 * 128, 1024)]


# ---------------------------------------------------------------------------
# plain versions: the kernels' f32 arithmetic
# ---------------------------------------------------------------------------

def residual_ln_fwd_plain(x, r, scale, bias):
    """out = LN(x + r) * scale + bias in f32, cast to x's dtype; mu and rstd
    (M, 1) f32, the variance taken in a second pass as the kernel does."""
    s = x.float() + r.float()
    mu = s.mean(dim=1, keepdim=True)
    d = s - mu
    rstd = torch.rsqrt((d * d).mean(dim=1, keepdim=True) + EPS)
    out = d * rstd * scale.float().reshape(1, -1) \
        + bias.float().reshape(1, -1)
    return out.to(x.dtype), mu, rstd


def residual_ln_bwd_plain(x, r, scale, mu, rstd, g):
    """(ds in x's dtype, dscale (H,) f32, dbias (H,) f32) from the saved mu
    and rstd (M, 1) and the recomputed s = x + r."""
    xhat = (x.float() + r.float() - mu) * rstd
    gf = g.float()
    gs = gf * scale.float().reshape(1, -1)
    m1 = gs.mean(dim=1, keepdim=True)
    m2 = (gs * xhat).mean(dim=1, keepdim=True)
    ds = ((gs - m1 - xhat * m2) * rstd).to(x.dtype)
    return ds, (gf * xhat).sum(dim=0), gf.sum(dim=0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_rows(name, x, others):
    """x: (M, H) contiguous f32/bf16 on CUDA; `others` ({name: tensor}) the
    same dtype, shape and device."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x has dtype {x.dtype}; the kernel takes "
                        "float32 or bfloat16")
    if x.ndim != 2 or x.shape[0] < 1:
        raise ValueError(f"{name}: x must be (M, H) with M >= 1, got "
                         f"{tuple(x.shape)}")
    h = x.shape[1]
    if h < 1 or h > (_MAX_H if h % 2 == 0 else _MAX_H_ODD):
        raise ValueError(f"{name}: no kernel build for H = {h}; the kernels "
                         f"take even H up to {_MAX_H} and odd H up to "
                         f"{_MAX_H_ODD}")
    for tn, t in [("x", x)] + list(others.items()):
        if t.device != x.device or t.dtype != x.dtype \
                or t.shape != x.shape:
            raise ValueError(f"{name}: {tn} is {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}; x is {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tn} must be contiguous and 16-byte "
                             "aligned")


def _vector(name, tn, t, h, device):
    """A (H,) or (1, H) f32 parameter as the kernels read it (the JAX call
    casts scale and bias to f32 the same way)."""
    if t.numel() != h or t.device != device:
        raise ValueError(f"{name}: {tn} must hold H = {h} values on "
                         f"{device}, got {tuple(t.shape)} on {t.device}")
    return t.reshape(h).to(torch.float32).contiguous()


def _run(name, tensors, ints):
    """Launch kernel `name` on checked inputs and allocated outputs, in the
    argument order of its .cu, on the current stream, and count the
    launch. The wrappers and the kernel-alone timing both launch here."""
    launch(name, tensors, ints)
    _WRAPPERS[name].launches += 1


def _fwd_args(x, r, scale, bias):
    """The forward's checks and allocation: (x, r, scale, bias, out, mu,
    rstd), (M, H, is_bf16)."""
    _check_rows("residual_ln_fwd", x, {"r": r})
    m, h = x.shape
    sc = _vector("residual_ln_fwd", "scale", scale, h, x.device)
    bi = _vector("residual_ln_fwd", "bias", bias, h, x.device)
    out = torch.empty_like(x)
    mu = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    return [x, r, sc, bi, out, mu, rstd], [m, h,
                                           int(x.dtype == torch.bfloat16)]


def bwd_blocks(m: int, h: int, dtype, device) -> int:
    """The backward's grid at (M, H, dtype) on `device`, as its library
    picks it (csrc/residual_ln_bwd.cu `residual_ln_bwd_config`, the one
    home of the rule): the blocks of 8 warps an SM holds (its occupancy,
    with the prefetch's registers and the per-warp sums' shared memory)
    times the SMs, no more than M / 8 rounded up; also the rows of its
    (blocks, 2, H) partial-sum workspace."""
    device = torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return config("residual_ln_bwd",
                  (m, h, int(dtype == torch.bfloat16), sms), 1,
                  device.index if device.index is not None
                  else torch.cuda.current_device())[0]


def _bwd_args(x, r, scale, mu, rstd, g):
    """The backward's checks and allocation: (x, r, scale, mu, rstd, g, ds,
    partial, dscale, dbias), (M, H, blocks, is_bf16)."""
    _check_rows("residual_ln_bwd", x, {"r": r, "g": g})
    m, h = x.shape
    sc = _vector("residual_ln_bwd", "scale", scale, h, x.device)
    for tn, t in (("mu", mu), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.numel() != m \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"residual_ln_bwd: {tn} must be a contiguous "
                             f"float32 (M, 1) = {(m, 1)} tensor on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)}")
    nblk = bwd_blocks(m, h, x.dtype, x.device)
    ds = torch.empty_like(x)
    partial = torch.empty((nblk, 2, h), dtype=torch.float32, device=x.device)
    dscale = torch.empty(h, dtype=torch.float32, device=x.device)
    dbias = torch.empty(h, dtype=torch.float32, device=x.device)
    return ([x, r, sc, mu, rstd, g, ds, partial, dscale, dbias],
            [m, h, nblk, int(x.dtype == torch.bfloat16)])


def residual_ln_fwd(x, r, scale, bias):
    """out = LN(x + r) * scale + bias (replaces `fwd_kernel`). x, r: (M, H)
    f32 or bf16; scale, bias: H values. Returns (out in x's dtype, mu,
    rstd (M, 1) f32)."""
    if not on_cuda("residual_ln_fwd", x):
        return residual_ln_fwd_plain(x, r, scale, bias)
    tensors, ints = _fwd_args(x, r, scale, bias)
    _run("residual_ln_fwd", tensors, ints)
    return tuple(tensors[4:])


def residual_ln_bwd(x, r, scale, mu, rstd, g):
    """Recompute-backward (replaces `bwd_kernel`). x, r, g: (M, H); scale:
    H values; mu, rstd: (M, 1) f32. Returns (ds in x's dtype, dscale (H,)
    f32, dbias (H,) f32); ds is the gradient of both x and r."""
    if not on_cuda("residual_ln_bwd", x):
        return residual_ln_bwd_plain(x, r, scale, mu, rstd, g)
    tensors, ints = _bwd_args(x, r, scale, mu, rstd, g)
    _run("residual_ln_bwd", tensors, ints)
    return tensors[6], tensors[8], tensors[9]


residual_ln_fwd.launches = 0
residual_ln_bwd.launches = 0
_WRAPPERS = {"residual_ln_fwd": residual_ln_fwd,
             "residual_ln_bwd": residual_ln_bwd}


def prepared_launches(x, r, scale, bias, g):
    """(forward, backward): zero-argument launches through `_run` on CUDA
    inputs checked and outputs allocated once, each counted as a launch.
    They time the kernels apart from the wrappers' checks and allocation,
    which at (16384, 768) take longer than the kernels."""
    fwd = _fwd_args(x, r, scale, bias)
    _, mu, rstd = residual_ln_fwd(x, r, scale, bias)
    bwd = _bwd_args(x, r, scale, mu, rstd, g)
    return (lambda: _run("residual_ln_fwd", *fwd),
            lambda: _run("residual_ln_bwd", *bwd))


class _FusedLN(torch.autograd.Function):
    """JAX's custom_vjp pair: the forward saves only x, r, scale, mu and
    rstd; the backward recomputes s = x + r and returns (ds, ds, dscale,
    dbias)."""

    @staticmethod
    def forward(x, r, scale, bias):
        return residual_ln_fwd(x, r, scale, bias)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, r, scale, bias = inputs
        _, mu, rstd = output
        ctx.save_for_backward(x, r, scale, mu, rstd)
        ctx.param_dtypes = (scale.dtype, bias.dtype)
        ctx.param_shapes = (scale.shape, bias.shape)
        ctx.mark_non_differentiable(mu, rstd)

    @staticmethod
    def backward(ctx, g, _dmu, _drstd):
        x, r, scale, mu, rstd = ctx.saved_tensors
        ds, dscale, dbias = residual_ln_bwd(x, r, scale, mu, rstd,
                                            g.to(x.dtype).contiguous())
        (sd, bd), (ss, bs) = ctx.param_dtypes, ctx.param_shapes
        return ds, ds, dscale.reshape(ss).to(sd), dbias.reshape(bs).to(bd)


def fused_ln(x, r, scale, bias):
    """LN(x + r) * scale + bias on the two kernels, with gradients for all
    four inputs. x, r: (M, H); scale, bias: (H,)."""
    return _FusedLN.apply(x, r, scale, bias)[0]


def torch_ln(x, r, scale, bias):
    """The plain composition (JAX `xla_ln`): autograd differentiates it op
    by op, saving s = x + r for the backward."""
    s = x.float() + r.float()
    mu = s.mean(dim=1, keepdim=True)
    d = s - mu
    var = (d * d).mean(dim=1, keepdim=True)
    return ((d * torch.rsqrt(var + EPS)) * scale + bias).to(x.dtype)


# ---------------------------------------------------------------------------
# the spike's table
# ---------------------------------------------------------------------------

def bound_bytes(m: int, h: int, elem: int):
    """Bytes each direction must move: forward reads x, r, scale, bias and
    writes out, mu, rstd; backward reads x, r, g, scale, mu, rstd and
    writes ds, dscale, dbias."""
    fwd = 3 * m * h * elem + 2 * 4 * h + 2 * 4 * m
    bwd = 4 * m * h * elem + 3 * 4 * h + 2 * 4 * m
    return fwd, bwd


def spike_inputs(m, h, dtype, seed, unit=False):
    """x, r ~ N(0, 1) in `dtype`; scale, bias ~ U(0, 1) f32 (the JAX spike's
    draws), or 1 and 0 with unit=True."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((m, h), generator=gen, device="cuda").to(dtype)
    r = torch.randn((m, h), generator=gen, device="cuda").to(dtype)
    if unit:
        return (x, r, torch.ones(h, device="cuda"),
                torch.zeros(h, device="cuda"))
    return (x, r, torch.rand(h, generator=gen, device="cuda"),
            torch.rand(h, generator=gen, device="cuda"))


def spike_table(seed=0, emit=print):
    """One row a shape and direction (bf16), as dicts; `emit` gets each."""
    import torch.nn.functional as F
    from .profile_gpt import time_ms

    rows = []
    for m, h in SHAPES:
        x, r, sc, b = spike_inputs(m, h, torch.bfloat16, seed)
        # correctness first, against the plain composition (the JAX spike's
        # check, at its tolerance)
        with torch.no_grad():
            err = (fused_ln(x, r, sc, b).float()
                   - torch_ln(x, r, sc, b).float()).abs().max().item()
        if not err <= 5e-2:
            raise RuntimeError(f"fused_ln differs from torch_ln by {err} at "
                               f"({m}, {h})")
        leaves = [t.detach().requires_grad_() for t in (x, r, sc, b)]
        sc16, b16 = sc.to(x.dtype), b.to(x.dtype)
        lib_leaves = [t.detach().requires_grad_() for t in (x, r, sc16, b16)]

        def grads(fn, ts):
            return torch.autograd.grad(fn(*ts).float().sum(), ts)

        def lib(xx, rr, ss, bb):
            return F.layer_norm(xx + rr, (h,), ss, bb, EPS)

        with torch.no_grad():
            fwd = {"fused_ln": time_ms(lambda: fused_ln(x, r, sc, b)),
                   "torch_ln": time_ms(lambda: torch_ln(x, r, sc, b)),
                   "library": time_ms(lambda: lib(x, r, sc16, b16))}
        both = {"fused_ln": time_ms(lambda: grads(fused_ln, leaves)),
                "torch_ln": time_ms(lambda: grads(torch_ln, leaves)),
                "library": time_ms(lambda: grads(lib, lib_leaves))}
        # the two kernels alone, without the wrappers' host work
        kf, kb = prepared_launches(x, r, sc, b, torch.randn_like(x))
        kernel = {"fwd": time_ms(kf)}
        kernel["fwd+bwd"] = kernel["fwd"] + time_ms(kb)
        fb, bb_ = bound_bytes(m, h, x.element_size())
        for mode, t, nbytes in (("fwd", fwd, fb), ("fwd+bwd", both,
                                                   fb + bb_)):
            row = {"phase": "spike", "M": m, "H": h, "dtype": "bfloat16",
                   "mode": mode, "fused_ln_ms": t["fused_ln"],
                   "kernels_alone_ms": kernel[mode],
                   "torch_ln_ms": t["torch_ln"],
                   "layer_norm_library_ms": t["library"],
                   "ratio_fused_to_torch_ln": t["fused_ln"] / t["torch_ln"],
                   "bound_bytes": nbytes,
                   "bound_ms": nbytes / PEAK_BYTES * 1e3,
                   "max_abs_err_fwd_vs_torch_ln": err}
            emit(row)
            rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spike_residual_ln: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"phase": "setup", "card": card,
                      "torch": torch.__version__}), flush=True)
    rows = spike_table(args.seed,
                       lambda row: print(json.dumps(row), flush=True))
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "spike_residual_ln.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
