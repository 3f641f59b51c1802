"""Spike: fused 1x1-conv + train-mode BatchNorm statistics (+ReLU) on two
hand-written Hopper kernels, against the plain composition.

    python3 -m paddle_tpu_torch.tools.spike_conv_bn [--seed N]

Port of `tools/spike_conv_bn.py`. A ResNet bottleneck's 1x1 conv in NHWC is a
plain product over (N*H*W, Cin) rows. The fused schedule computes the
product and, as its epilogue, each column's sum and sum of squares (saving
the separate statistics pass over y); a second pass normalises and applies
the ReLU. Train-mode BN cannot be one pass (the statistics reduce over all
M rows), so every schedule moves at least x read + y written + y read + out
written. Its two TPU kernels become CUDA C++ kernels for sm_90a
(`ops/csrc/conv_bn_stats.cu`, `bn_apply_relu.cu`), built at first use and
bound with ctypes:

  `fused_conv_bn_stats` (:26) -> `fused_conv_bn_stats` / `conv_bn_stats`
  `bn_apply_relu` (:88)       -> `bn_apply_relu`

Each wrapper runs its kernel on CUDA tensors (checking device, dtype, shape
and alignment, raising if the launch is refused, and adding one to its
`launches` count) and its plain version (`<name>_plain`) on CPU tensors;
anything else raises. `fused_block` is the JAX `fused_block` (:120) and
`torch_block` the plain composition (JAX `xla_block`, :125). No program
calls them: the spike is its own entry point, as in the JAX package, and
the port's ResNet-50 runs its convs through cuDNN.

`main()` prints the spike's table on the card at the JAX spike's five
shapes (ResNet-50's bottleneck 1x1 convs at batch 128, M floored to a
multiple of 512 as the JAX `main` does): fused_block, the two kernels alone
(launched through the wrappers' `_run` on inputs checked and outputs
allocated once), torch_block, and the bound of the whole block.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from ..ops.cuda_build import launch, on_cuda

__all__ = ["EPS", "SHAPES", "fused_conv_bn_stats", "bn_apply_relu",
           "fused_conv_bn_stats_plain", "bn_apply_relu_plain",
           "bn_scale_shift", "fused_block", "torch_block",
           "prepared_launches", "stats_bound", "apply_bound", "block_bound",
           "spike_table", "main"]

EPS = 1e-5
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989.4e12  # H100 SXM bf16 dense tensor-core peak
_BM = 128                   # rows of y a conv_bn_stats block computes (csrc)

# (N*H*W, Cin, Cout) of ResNet-50's bottleneck 1x1 convs at batch 128, M
# floored to a multiple of 512 as the JAX spike's main does (only the last
# changes: 6272 -> 6144)
SHAPES = [((m // 512) * 512, k, c) for m, k, c in (
    (128 * 56 * 56, 64, 64), (128 * 56 * 56, 64, 256),
    (128 * 28 * 28, 512, 128), (128 * 14 * 14, 1024, 256),
    (128 * 7 * 7, 2048, 512))]


# ---------------------------------------------------------------------------
# plain versions: the kernels' arithmetic in torch
# ---------------------------------------------------------------------------

def fused_conv_bn_stats_plain(x, w):
    """y = x @ w in f32, stored in x's dtype; s, q: the column sums of the
    f32 y and of its square, before the rounding."""
    y = x.float() @ w.float()
    return y.to(x.dtype), y.sum(dim=0), (y * y).sum(dim=0)


def bn_scale_shift(s, q, m, gamma, beta, eps=EPS):
    """The JAX wrapper's folding of the statistics (:96-99), in f32: mean =
    s / m, var = q / m - mean^2 (the E[y^2] form), scale = gamma /
    sqrt(var + eps), shift = beta - mean * scale."""
    mean = s.float() / m
    var = q.float() / m - mean * mean
    scale = gamma.float() / torch.sqrt(var + eps)
    return scale, beta.float() - mean * scale


def bn_apply_relu_plain(y, s, q, gamma, beta, eps=EPS):
    """relu(y * scale + shift) in f32, stored in y's dtype."""
    scale, shift = bn_scale_shift(s, q, y.shape[0], gamma, beta, eps)
    return torch.relu(y.float() * scale + shift).to(y.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, tn, t, shape, dtype, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device:
        raise ValueError(f"{name}: {tn} must be {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: {tn} must be contiguous and 16-byte "
                         "aligned")


def _run(name, tensors, ints):
    """Launch kernel `name` on checked inputs and allocated outputs, in the
    argument order of its .cu, on the current stream, and count the launch.
    The wrappers and the kernel-alone timing both launch here."""
    launch(name, tensors, ints)
    _WRAPPERS[name].launches += 1


def _stats_args(x, w):
    """conv_bn_stats' checks and allocation: (x, w, y, partial, s, q),
    (M, K, C, row_blocks)."""
    name = "conv_bn_stats"
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: x (M, K) and w (K, C) do not chain: "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    c = w.shape[1]
    if m < 1 or k % 8 or c % 8 or k < 8 or c < 8:
        raise ValueError(f"{name}: the kernel takes M >= 1 and K, C "
                         f"multiples of 8; got M={m}, K={k}, C={c}")
    _check(name, "x", x, (m, k), torch.bfloat16, x.device)
    _check(name, "w", w, (k, c), torch.bfloat16, x.device)
    blocks = -(-m // _BM)
    y = torch.empty((m, c), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((blocks, 2, c), dtype=torch.float32,
                          device=x.device)
    s = torch.empty(c, dtype=torch.float32, device=x.device)
    q = torch.empty(c, dtype=torch.float32, device=x.device)
    return [x, w, y, partial, s, q], [m, k, c, blocks]


def _apply_blocks(device) -> int:
    """bn_apply_relu's grid: 16 blocks of 256 threads an SM, grid-stride."""
    return 16 * torch.cuda.get_device_properties(device).multi_processor_count


def _apply_args(y, scale, shift):
    """bn_apply_relu's checks and allocation: (y, scale, shift, out), (M,
    C, vec8, blocks)."""
    name = "bn_apply_relu"
    if y.ndim != 2 or y.shape[0] < 1 or y.shape[1] < 1:
        raise ValueError(f"{name}: y must be (M, C), got {tuple(y.shape)}")
    m, c = y.shape
    _check(name, "y", y, (m, c), torch.bfloat16, y.device)
    sc = scale.to(torch.float32).contiguous()
    sh = shift.to(torch.float32).contiguous()
    _check(name, "scale", sc, (c,), torch.float32, y.device)
    _check(name, "shift", sh, (c,), torch.float32, y.device)
    out = torch.empty_like(y)
    return [y, sc, sh, out], [m, c, int(c % 8 == 0), _apply_blocks(y.device)]


def fused_conv_bn_stats(x, w):
    """y = x @ w with the column statistics (replaces `fused_conv_bn_stats`).
    x: (M, K) bf16, w: (K, C) bf16, K and C multiples of 8. Returns (y (M, C)
    bf16, s (C,) f32, q (C,) f32), the sums of the f32 product and of its
    square."""
    if not on_cuda("conv_bn_stats", x):
        return fused_conv_bn_stats_plain(x, w)
    tensors, ints = _stats_args(x, w)
    _run("conv_bn_stats", tensors, ints)
    return tensors[2], tensors[4], tensors[5]


def bn_apply_relu(y, s, q, gamma, beta, eps=EPS):
    """relu((y - mean) / sqrt(var + eps) * gamma + beta) with the batch
    statistics of s and q over y's M rows (replaces `bn_apply_relu`). y:
    (M, C) bf16; s, q, gamma, beta: (C,). Returns (M, C) bf16."""
    if not on_cuda("bn_apply_relu", y):
        return bn_apply_relu_plain(y, s, q, gamma, beta, eps)
    scale, shift = bn_scale_shift(s, q, y.shape[0], gamma, beta, eps)
    tensors, ints = _apply_args(y, scale, shift)
    _run("bn_apply_relu", tensors, ints)
    return tensors[3]


fused_conv_bn_stats.launches = 0
bn_apply_relu.launches = 0
_WRAPPERS = {"conv_bn_stats": fused_conv_bn_stats,
             "bn_apply_relu": bn_apply_relu}


def fused_block(x, w, gamma, beta, eps=EPS):
    """The JAX `fused_block`: the two kernels in turn."""
    y, s, q = fused_conv_bn_stats(x, w)
    return bn_apply_relu(y, s, q, gamma, beta, eps)


def torch_block(x, w, gamma, beta, eps=EPS):
    """The plain composition (JAX `xla_block`): the product in x's dtype,
    then the statistics and the normalisation in f32."""
    y = (x @ w).float()
    mean = y.mean(dim=0)
    var = (y * y).mean(dim=0) - mean * mean
    out = (y - mean) * (gamma / torch.sqrt(var + eps)) + beta
    return torch.relu(out).to(x.dtype)


def prepared_launches(x, w, gamma, beta, eps=EPS):
    """(conv_bn_stats, bn_apply_relu): zero-argument launches through `_run`
    on CUDA inputs checked and outputs allocated once, each counted as a
    launch; they time the kernels apart from the wrappers' host work."""
    stats = _stats_args(x, w)
    y, s, q = fused_conv_bn_stats(x, w)
    apply = _apply_args(y, *bn_scale_shift(s, q, y.shape[0], gamma, beta,
                                           eps))
    return (lambda: _run("conv_bn_stats", *stats),
            lambda: _run("bn_apply_relu", *apply))


# ---------------------------------------------------------------------------
# bounds and the spike's table
# ---------------------------------------------------------------------------

def _bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def stats_bound(m, k, c):
    """(ms, bound_by, FLOPs, bytes) of conv_bn_stats at the bf16 peak: the
    product (2MKC) and the epilogue's add, multiply-add (3MC); x, w read,
    y written in bf16, s and q written in f32."""
    return _bound(2.0 * m * k * c + 3.0 * m * c,
                  2 * (m * k + k * c + m * c) + 2 * 4 * c, PEAK_BF16_FLOPS)


def apply_bound(m, c):
    """(ms, bound_by, FLOPs, bytes) of bn_apply_relu: y read and out written
    in bf16, scale and shift read in f32; a multiply, an add and a max a
    value."""
    return _bound(3.0 * m * c, 2 * 2 * m * c + 2 * 4 * c, PEAK_BF16_FLOPS)


def block_bound(m, k, c):
    """The whole block: both kernels' work, y written and read once."""
    a, b = stats_bound(m, k, c), apply_bound(m, c)
    return _bound(a[2] + b[2], a[3] + b[3], PEAK_BF16_FLOPS)


def spike_inputs(m, k, c, seed):
    """The JAX spike's inputs on the card: x ~ 0.1 N(0, 1), w ~ 0.05 N(0, 1)
    in bf16, gamma 1 and beta 0 in f32."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = (torch.randn((m, k), generator=gen, device="cuda") * 0.1) \
        .to(torch.bfloat16)
    w = (torch.randn((k, c), generator=gen, device="cuda") * 0.05) \
        .to(torch.bfloat16)
    return x, w, torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")


def spike_table(seed=0, emit=print):
    """One row a shape, as dicts; `emit` gets each."""
    from .profile_gpt import time_ms
    rows = []
    for m, k, c in SHAPES:
        x, w, gamma, beta = spike_inputs(m, k, c, seed)
        # correctness first, against the plain composition (the JAX spike's
        # check, at its tolerance)
        err = (fused_block(x, w, gamma, beta).float()
               - torch_block(x, w, gamma, beta).float()).abs().max().item()
        if not err <= 0.15:
            raise RuntimeError(f"fused_block differs from torch_block by "
                               f"{err} at ({m}, {k}, {c})")
        ks, ka = prepared_launches(x, w, gamma, beta)
        stats_ms, apply_ms = time_ms(ks), time_ms(ka)
        bound_ms, bound_by, flops, nbytes = block_bound(m, k, c)
        row = {"phase": "spike", "M": m, "K": k, "C": c,
               "dtype": "bfloat16",
               "fused_block_ms": time_ms(lambda: fused_block(x, w, gamma,
                                                             beta)),
               "kernels_alone_ms": stats_ms + apply_ms,
               "conv_bn_stats_ms": stats_ms, "bn_apply_relu_ms": apply_ms,
               "torch_block_ms": time_ms(lambda: torch_block(x, w, gamma,
                                                             beta)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "flops": flops, "bytes": nbytes,
               "max_abs_err_vs_torch_block": err}
        row["ratio_fused_to_torch_block"] = \
            row["fused_block_ms"] / row["torch_block_ms"]
        emit(row)
        rows.append(row)
        del x, w
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spike_conv_bn: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
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
    with open(os.path.join(out_dir, "spike_conv_bn.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
