"""Fused multi-head attention: two hand-written Hopper forward kernels, their
plain PyTorch versions, and the reference.

Port of `paddle_tpu/ops/flash_attention.py` (forward half). The TPU kernels
`_fwd_kernel` (:84) and `_small_fwd_kernel` (:266) become CUDA C++ kernels
for sm_90a in `csrc/flash_fwd.cu` and `csrc/flash_small_fwd.cu`, built at
first use (`cuda_build.py`) and bound with ctypes. Each has a wrapper
(`flash_fwd`, `flash_small_fwd`) over the (b*n, s, d) layout that

  * on a CUDA tensor checks device, dtype, shape and contiguity, allocates
    the outputs, launches the kernel on the current stream, raises if the
    launch was refused, and adds one to its `launches` count;
  * on a CPU tensor runs the kernel's plain version (`flash_fwd_plain`,
    `flash_small_fwd_plain`) — the counterpart of the JAX package's
    interpret mode; anything else raises. Nothing falls back.

Both return (o, lse): o in the input dtype, lse f32 (b*n, sq) — the TPU
kernels' 128-lane lse padding was a Mosaic artifact and is gone.

Public functions keep the (batch, seq, heads, head_dim) layout;
`_to_bn`/`_from_bn` (:617-624) are real copies here too. The backward
kernels and the custom-gradient wrapper come with the training slice.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np
import torch

__all__ = ["attention", "attention_fwd_lse", "flash_dispatch",
           "mha_reference", "flash_fwd", "flash_small_fwd",
           "flash_fwd_plain", "flash_small_fwd_plain"]

_NEG_INF = -1e30
_KERNEL_MAX_HEAD_DIM = 256   # csrc/flash_common.cuh kMaxHeadDim
_BLOCK_K = 64                # flash_fwd's k-tile (csrc BK)


def mha_reference(q, k, v, bias=None, causal: bool = False,
                  sm_scale: Optional[float] = None):
    """Plain attention. q: (b, sq, n, d); k/v: (b, sk, n, d); bias: additive,
    broadcastable to (b, n, sq, sk). Returns (b, sq, n, d). The causal mask
    is top-left aligned (row >= col in absolute indices), as in the JAX
    reference; masked scores are -1e30, not -inf."""
    if sm_scale is None:
        sm_scale = 1.0 / np.sqrt(q.shape[-1])
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=s.device).tril()
        s = torch.where(keep, s, torch.full((), _NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bnqk,bknd->bqnd", p, v)


# ---------------------------------------------------------------------------
# plain versions of the two kernels (the CPU path, and the yardstick the
# kernels are checked against on the card)
# ---------------------------------------------------------------------------

def _masked_scores(q, k, bias, causal, sm_scale, q0=0, k0=0):
    """f32 scores of q rows [q0, q0+len) against k cols [k0, k0+len) with
    the kernels' masking: per-key bias, then causal row >= col."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias[:, None, k0:k0 + k.shape[1]].float()
    if causal:
        rows = torch.arange(q0, q0 + q.shape[1], device=q.device)[:, None]
        cols = torch.arange(k0, k0 + k.shape[1], device=q.device)[None, :]
        s = torch.where(rows >= cols, s,
                        torch.full((), _NEG_INF, device=s.device))
    return s


def flash_fwd_plain(q, k, v, bias=None, causal=False, sm_scale=1.0,
                    block_k: int = _BLOCK_K):
    """The tiled kernel's function, written as its arithmetic: an online
    softmax over k-tiles of `block_k` keys with running max m, sum l and an
    f32 accumulator; tiles strictly above the causal diagonal are skipped.
    q: (bn, sq, d); k/v: (bn, sk, d); bias: (bn, sk) f32 or None.
    Returns (o (bn, sq, d) in q's dtype, lse (bn, sq) f32)."""
    bn, sq, d = q.shape
    sk = k.shape[1]
    m = torch.full((bn, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bn, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bn, sq, d), dtype=torch.float32, device=q.device)
    nk = -(-sk // block_k)
    if causal:
        nk = min(nk, (sq - 1) // block_k + 1)
    for t in range(nk):
        k0 = t * block_k
        kt, vt = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        s = _masked_scores(q, kt, bias, causal, sm_scale, 0, k0)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vt.float())
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(q.dtype), m + torch.log(l_safe)


def flash_small_fwd_plain(q, k, v, bias=None, causal=False, sm_scale=1.0):
    """The single-pass kernel's function: exact softmax over whole score
    rows (row max, then exp-sum), then P.V. Same arguments and returns as
    `flash_fwd_plain`."""
    s = _masked_scores(q, k, bias, causal, sm_scale)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul(p, v.float()) / l[..., None]
    return o.to(q.dtype), m + torch.log(l)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                          ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _kernel_fn(lib_name: str, symbol: str):
    from .cuda_build import load_library
    fn = getattr(load_library(lib_name), symbol)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(name, q, k, v, bias):
    for t, tn in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_cuda:
            raise ValueError(f"{name}: {tn} is on {t.device}, q on CUDA")
        if t.device != q.device:
            raise ValueError(f"{name}: {tn} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: {tn} has dtype {t.dtype}; the kernel "
                            "takes float32 or bfloat16")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {tn} is {t.dtype}, q is {q.dtype}")
        if t.ndim != 3:
            raise ValueError(f"{name}: {tn} must be (b*n, s, d), got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tn} must be contiguous and 16-byte "
                             "aligned")
    bn, sq, d = q.shape
    if bn > 65535:
        raise ValueError(f"{name}: b*n = {bn} exceeds the grid's 65535 "
                         "blocks in y")
    if k.shape != v.shape or k.shape[0] != bn or k.shape[2] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if d % 4 or not 0 < d <= _KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"{name}: no kernel build for head_dim {d}; the "
                         "kernels take d % 4 == 0 up to "
                         f"{_KERNEL_MAX_HEAD_DIM}")
    if bias is not None:
        if (not bias.is_cuda or bias.device != q.device
                or bias.dtype != torch.float32
                or tuple(bias.shape) != (bn, k.shape[1])
                or not bias.is_contiguous()):
            raise ValueError(f"{name}: bias must be a contiguous float32 "
                             f"(b*n, sk) = {(bn, k.shape[1])} tensor on "
                             f"{q.device}, got {bias.dtype} "
                             f"{tuple(bias.shape)} on {bias.device}")


def _launch(name, symbol, q, k, v, bias, causal, sm_scale):
    _check_cuda_args(name, q, k, v, bias)
    bn, sq, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((bn, sq), dtype=torch.float32, device=q.device)
    fn = _kernel_fn(name, symbol)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 o.data_ptr(), lse.data_ptr(), bn, sq, sk, d,
                 int(q.dtype == torch.bfloat16), int(bool(causal)),
                 float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err} (bn={bn}, sq={sq}, sk={sk}, d={d}, "
                           f"{q.dtype})")
    return o, lse


def flash_fwd(q, k, v, bias=None, causal=False, sm_scale=1.0):
    """Tiled online-softmax forward (replaces `_fwd_kernel`). q: (bn, sq, d);
    k/v: (bn, sk, d); bias: (bn, sk) f32 or None. Returns (o, lse)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, bias, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: no kernel for device {q.device}")
    out = _launch("flash_fwd", "flash_fwd_launch", q, k, v, bias, causal,
                  sm_scale)
    flash_fwd.launches += 1
    return out


def flash_small_fwd(q, k, v, bias=None, causal=False, sm_scale=1.0):
    """Single-pass exact-softmax forward for sq, sk <= 512 (replaces
    `_small_fwd_kernel`). Same arguments and returns as `flash_fwd`."""
    if q.device.type == "cpu":
        return flash_small_fwd_plain(q, k, v, bias, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_small_fwd: no kernel for device {q.device}")
    if k.shape[1] > 2048:
        raise ValueError("flash_small_fwd: sk > 2048 does not fit the "
                         "kernel's shared-memory score rows")
    out = _launch("flash_small_fwd", "flash_small_fwd_launch", q, k, v, bias,
                  causal, sm_scale)
    flash_small_fwd.launches += 1
    return out


flash_fwd.launches = 0
flash_small_fwd.launches = 0


# ---------------------------------------------------------------------------
# layout plumbing and dispatch
# ---------------------------------------------------------------------------

def _small_ok(sq, sk):
    """Shapes the single-pass path handles (the JAX rule, :409)."""
    return sq <= 512 and sk <= 512 and sk % 128 == 0 and sq % 8 == 0


def _to_bn(x):
    b, s, n, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * n, s, d)


def _from_bn(x, b, n):
    bn, s, d = x.shape
    return x.reshape(b, n, s, d).permute(0, 2, 1, 3)


def _bias_to_bn(bias, b, n, sk):
    """Accepts (b, 1, 1, sk) / (b, sk) per-key additive bias -> (b*n, sk)
    f32, contiguous."""
    bias = bias.reshape(b, -1)[:, -sk:]
    return torch.repeat_interleave(bias.float(), n, dim=0).contiguous()


def _flash_fwd(q, k, v, bias, causal, sm_scale):
    """(b, s, n, d) in -> (o (b, sq, n, d), lse (b*n, sq)) through the
    kernel the JAX package would pick for these shapes."""
    b, sq, n, d = q.shape
    sk = k.shape[1]
    bb = None if bias is None else _bias_to_bn(bias, b, n, sk)
    call = flash_small_fwd if _small_ok(sq, sk) else flash_fwd
    o, lse = call(_to_bn(q), _to_bn(k), _to_bn(v), bb, causal, sm_scale)
    return _from_bn(o, b, n), lse


def flash_dispatch(q, k, bias=None, impl: Optional[str] = None):
    """The dispatch decision: (use_flash, plain). The JAX rule (:673) with
    "on the TPU" read as "the tensors are on CUDA": same impl /
    FLAGS_attention_impl handling, per-key-bias and shape checks and the
    sk >= 256 threshold (a TPU tuning, kept until it is re-measured on the
    card). `plain` is True off CUDA, where impl="flash" runs the kernels'
    plain versions."""
    if impl is None:
        impl = os.environ.get("FLAGS_attention_impl", "")
    flag_ok = impl in ("", "auto", "flash")
    on_cuda = q.device.type == "cuda"
    bias_ok = bias is None or bias.ndim == 2 or (
        bias.ndim == 4 and bias.shape[1] == 1 and bias.shape[2] == 1)
    shapes_ok = (q.shape[-1] % 8 == 0 and q.shape[1] % 8 == 0
                 and k.shape[1] % 128 == 0)
    long_enough = k.shape[1] >= 256
    if impl == "flash" and not bias_ok:
        raise ValueError(
            "flash attention requires a per-key bias of shape (b, sk) or "
            f"(b, 1, 1, sk); got {tuple(bias.shape)}. Use impl='xla' for "
            "general biases.")
    use = impl == "flash" or (flag_ok and on_cuda and bias_ok and shapes_ok
                              and long_enough and impl != "xla")
    return use, not on_cuda


def attention(q, k, v, bias=None, causal: bool = False,
              sm_scale: Optional[float] = None, impl: Optional[str] = None):
    """Dispatching fused attention (forward). impl: None (auto) | 'flash' |
    'xla' (the plain reference)."""
    return attention_fwd_lse(q, k, v, bias, causal, sm_scale, impl)[0]


def attention_fwd_lse(q, k, v, bias=None, causal: bool = False,
                      sm_scale: Optional[float] = None,
                      impl: Optional[str] = None):
    """Forward returning (out, lse): lse is the kernel's (b*n, sq) f32 row
    log-sum-exp on the flash path, None on the reference path."""
    if sm_scale is None:
        sm_scale = 1.0 / np.sqrt(q.shape[-1])
    use_flash, _ = flash_dispatch(q, k, bias, impl)
    if not use_flash:
        return mha_reference(q, k, v, bias, causal, sm_scale), None
    return _flash_fwd(q, k, v, bias, causal, float(sm_scale))
