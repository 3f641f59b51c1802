"""Fused multi-head attention: five hand-written Hopper kernels (two forward,
three backward), their plain PyTorch versions, and the reference.

Port of `paddle_tpu/ops/flash_attention.py`. The TPU kernels become CUDA C++
kernels for sm_90a under `csrc/`, built at first use (`cuda_build.py`) and
bound with ctypes:

  `_fwd_kernel` (:84)        -> `flash_fwd`        (csrc/flash_fwd.cu)
  `_small_fwd_kernel` (:266) -> `flash_small_fwd`  (csrc/flash_small_fwd.cu)
  `_bwd_dkv_kernel` (:134)   -> `flash_bwd_dkv`    (csrc/flash_bwd_dkv.cu)
  `_bwd_dq_kernel` (:188)    -> `flash_bwd_dq`     (csrc/flash_bwd_dq.cu)
  `_small_bwd_kernel` (:279) -> `flash_small_bwd`  (csrc/flash_small_bwd.cu)

Each wrapper works on the (b*n, s, d) layout and

  * on a CUDA tensor checks device, dtype, shape and contiguity, allocates
    the outputs, launches the kernel on the current stream, raises if the
    launch was refused, and adds one to its `launches` count;
  * on a CPU tensor runs the kernel's plain version (`<name>_plain`) —
    the counterpart of the JAX package's interpret mode; anything else
    raises. Nothing falls back.

The forward kernels return (o, lse): o in the input dtype, lse f32
(b*n, sq) — the TPU kernels' 128-lane lse padding was a Mosaic artifact and
is gone. The backward kernels take the saved lse and Δ = rowsum(dO∘O),
computed here in torch before the launch as JAX computes it outside
`pallas_call` (:356, :501).

Public functions keep the (batch, seq, heads, head_dim) layout;
`_to_bn`/`_from_bn` (:617-624) are real copies here too. `flash_attention`
(:633, a jax.custom_vjp there) is a torch.autograd.Function, so
`attention()` on the flash path has gradients, the per-key bias's
included.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np
import torch

__all__ = ["attention", "attention_fwd_lse", "attention_bwd_saved",
           "flash_attention", "flash_dispatch", "mha_reference",
           "flash_fwd", "flash_small_fwd", "flash_bwd_dkv", "flash_bwd_dq",
           "flash_small_bwd", "flash_fwd_plain", "flash_small_fwd_plain",
           "flash_bwd_dkv_plain", "flash_bwd_dq_plain",
           "flash_small_bwd_plain", "fwd_block_k", "tiled_body"]

_NEG_INF = -1e30
_KERNEL_MAX_HEAD_DIM = 256   # csrc/flash_common.cuh kMaxHeadDim
_BWD_TILE = 64               # rows a backward block owns (csrc kBwdOwn)


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


def fwd_block_k(sk: int) -> int:
    """Keys of one step of the reference's tiled forward: `_pick_blocks`'s
    rule (JAX :420-423), all of sk up to 512 keys, 512 where that divides
    sk, else 128. The running
    max, and so the value at which p is rounded to v's dtype, steps at these
    blocks; the kernel (csrc/flash_fwd_body.cuh) reads the same rule."""
    b = min(512, sk)
    return b if sk % b == 0 else 128


def flash_fwd_plain(q, k, v, bias=None, causal=False, sm_scale=1.0):
    """The tiled kernel's function, written as the reference's arithmetic
    (`_fwd_kernel`, :106-111): an online softmax over k-blocks of
    `fwd_block_k(sk)` keys with running max m, sum l and an f32
    accumulator; each block's p = exp(s - m_new) is summed into l in f32
    and rounded to v's dtype before P.V (a no-op in fp32); blocks strictly
    above the causal diagonal are skipped. q: (bn, sq, d); k/v: (bn, sk,
    d); bias: (bn, sk) f32 or None. Returns (o (bn, sq, d) in q's dtype,
    lse (bn, sq) f32)."""
    bn, sq, d = q.shape
    sk = k.shape[1]
    block_k = fwd_block_k(sk)
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
        acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(),
                                                    vt.float())
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(q.dtype), m + torch.log(l_safe)


def flash_small_fwd_plain(q, k, v, bias=None, causal=False, sm_scale=1.0):
    """The single-pass kernel's function: exact softmax over whole score
    rows (row max, then exp-sum), then P.V with the normalised P = p / l
    rounded to v's dtype first, as the JAX kernel does (:272; a no-op in
    fp32). Same arguments and returns as `flash_fwd_plain`."""
    s = _masked_scores(q, k, bias, causal, sm_scale)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul((p / l[..., None]).to(v.dtype).float(), v.float())
    return o.to(q.dtype), m + torch.log(l)


def _bwd_probs(q, k, v, bias, do, lse, delta, causal, sm_scale, q0=0,
               k0=0):
    """The backward kernels' arithmetic on one (query rows, keys) tile:
    P = exp(S - lse) from the recomputed masked scores, and the unscaled
    dS = P * (dO.V^T - delta). Returns (p, ds), f32."""
    s = _masked_scores(q, k, bias, causal, sm_scale, q0, k0)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_bwd_dkv_plain(q, k, v, bias, do, lse, delta, causal=False,
                        sm_scale=1.0, block_q: int = _BWD_TILE):
    """The key-owning backward kernel's function: over q-tiles of
    `block_q` rows, dV += P^T.dO, dK += dS^T.Q and db += colsum(dS), then
    dK scaled by sm_scale. q, do: (bn, sq, d); k/v: (bn, sk, d); bias:
    (bn, sk) f32 or None; lse, delta: (bn, sq) f32. Returns (dk, dv, db):
    dk, dv in k's and v's dtype, db (bn, sk) f32 or None."""
    bn, sq, d = q.shape
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    db = torch.zeros(k.shape[:2], dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, block_q):
        sl = slice(q0, q0 + block_q)
        p, ds = _bwd_probs(q[:, sl], k, v, bias, do[:, sl], lse[:, sl],
                           delta[:, sl], causal, sm_scale, q0)
        dv += torch.matmul(p.transpose(-1, -2), do[:, sl].float())
        dk += torch.matmul(ds.transpose(-1, -2), q[:, sl].float())
        db += ds.sum(dim=1)
    return ((dk * sm_scale).to(k.dtype), dv.to(v.dtype),
            db if bias is not None else None)


def flash_bwd_dq_plain(q, k, v, bias, do, lse, delta, causal=False,
                       sm_scale=1.0, block_k: int = _BWD_TILE):
    """The query-owning backward kernel's function: over k-tiles of
    `block_k` keys, dQ += dS.K, then scaled by sm_scale. Arguments as
    `flash_bwd_dkv_plain`; returns dq in q's dtype."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, k.shape[1], block_k):
        sl = slice(k0, k0 + block_k)
        _, ds = _bwd_probs(q, k[:, sl], v[:, sl], bias, do, lse, delta,
                           causal, sm_scale, 0, k0)
        dq += torch.matmul(ds, k[:, sl].float())
    return (dq * sm_scale).to(q.dtype)


def flash_small_bwd_plain(q, k, v, bias, do, lse, delta, causal=False,
                          sm_scale=1.0):
    """The single-launch short-sequence backward's function, on the whole
    (sq, sk) tile at once. Returns (dq, dk, dv, db) as the two plain
    versions above do."""
    p, ds = _bwd_probs(q, k, v, bias, do, lse, delta, causal, sm_scale)
    dq = torch.matmul(ds, k.float()) * sm_scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * sm_scale
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            ds.sum(dim=1) if bias is not None else None)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _argtypes(n_ptrs):
    """n_ptrs device pointers, then bn, sq, sk, d, is_bf16, causal,
    sm_scale and the stream."""
    return [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _kernel_fn(lib_name: str, symbol: str, n_ptrs: int = 6):
    from .cuda_build import load_library
    fn = getattr(load_library(lib_name), symbol)
    fn.argtypes = _argtypes(n_ptrs)
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


def _check_bwd_args(name, q, k, v, bias, do, lse, delta):
    _check_cuda_args(name, q, k, v, bias)
    if (do.device != q.device or do.dtype != q.dtype
            or do.shape != q.shape or not do.is_contiguous()
            or do.data_ptr() % 16):
        raise ValueError(f"{name}: do must be a contiguous {q.dtype} "
                         f"{tuple(q.shape)} tensor on {q.device}, got "
                         f"{do.dtype} {tuple(do.shape)} on {do.device}")
    for t, tn in ((lse, "lse"), (delta, "delta")):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != tuple(q.shape[:2])
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {tn} must be a contiguous float32 "
                             f"(b*n, sq) = {tuple(q.shape[:2])} tensor on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def _launch(name, symbol, q, k, v, bias, tensors, causal, sm_scale):
    """Launch `symbol` of library `name` on the current stream with the
    pointers of q, k, v, bias and then `tensors`; raise if refused."""
    bn, sq, d = q.shape
    sk = k.shape[1]
    ptrs = [t.data_ptr() for t in (q, k, v)] + [
        bias.data_ptr() if bias is not None else None] + [
        t.data_ptr() if t is not None else None for t in tensors]
    fn = _kernel_fn(name, symbol, len(ptrs))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, bn, sq, sk, d, int(q.dtype == torch.bfloat16),
                 int(bool(causal)), float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err} (bn={bn}, sq={sq}, sk={sk}, d={d}, "
                           f"{q.dtype})")


def _launch_fwd(name, q, k, v, bias, causal, sm_scale):
    _check_cuda_args(name, q, k, v, bias)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch(name, f"{name}_launch", q, k, v, bias, (o, lse), causal,
            sm_scale)
    return o, lse


def _no_kernel(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")


def flash_fwd(q, k, v, bias=None, causal=False, sm_scale=1.0):
    """Tiled online-softmax forward (replaces `_fwd_kernel`). q: (bn, sq, d);
    k/v: (bn, sk, d); bias: (bn, sk) f32 or None. Returns (o, lse)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, bias, causal, sm_scale)
    _no_kernel("flash_fwd", q)
    out = _launch_fwd("flash_fwd", q, k, v, bias, causal, sm_scale)
    flash_fwd.launches += 1
    return out


def flash_small_fwd(q, k, v, bias=None, causal=False, sm_scale=1.0):
    """Single-pass exact-softmax forward for sq, sk <= 512 (replaces
    `_small_fwd_kernel`). Same arguments and returns as `flash_fwd`."""
    if q.device.type == "cpu":
        return flash_small_fwd_plain(q, k, v, bias, causal, sm_scale)
    _no_kernel("flash_small_fwd", q)
    if k.shape[1] > 2048:
        raise ValueError("flash_small_fwd: sk > 2048 is past the "
                         "single-pass kernel's range; flash_fwd takes "
                         "long sequences")
    out = _launch_fwd("flash_small_fwd", q, k, v, bias, causal, sm_scale)
    flash_small_fwd.launches += 1
    return out


def _bwd_outputs(q, k, v, bias, with_dq, with_dkv):
    dq = torch.empty_like(q) if with_dq else None
    dk = torch.empty_like(k) if with_dkv else None
    dv = torch.empty_like(v) if with_dkv else None
    db = (torch.empty(k.shape[:2], dtype=torch.float32, device=q.device)
          if with_dkv and bias is not None else None)
    return dq, dk, dv, db


def flash_bwd_dkv(q, k, v, bias, do, lse, delta, causal=False,
                  sm_scale=1.0):
    """Key-owning tiled backward (replaces `_bwd_dkv_kernel`): dK, dV and
    the per-key bias grad. q, do: (bn, sq, d); k/v: (bn, sk, d); bias:
    (bn, sk) f32 or None; lse, delta: (bn, sq) f32. Returns (dk, dv, db),
    db (bn, sk) f32 or None."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, bias, do, lse, delta, causal,
                                   sm_scale)
    _no_kernel("flash_bwd_dkv", q)
    _check_bwd_args("flash_bwd_dkv", q, k, v, bias, do, lse, delta)
    _, dk, dv, db = _bwd_outputs(q, k, v, bias, False, True)
    _launch("flash_bwd_dkv", "flash_bwd_dkv_launch", q, k, v, bias,
            (do, lse, delta, dk, dv, db), causal, sm_scale)
    flash_bwd_dkv.launches += 1
    return dk, dv, db


def flash_bwd_dq(q, k, v, bias, do, lse, delta, causal=False, sm_scale=1.0):
    """Query-owning tiled backward (replaces `_bwd_dq_kernel`). Arguments
    as `flash_bwd_dkv`; returns dq."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, bias, do, lse, delta, causal,
                                  sm_scale)
    _no_kernel("flash_bwd_dq", q)
    _check_bwd_args("flash_bwd_dq", q, k, v, bias, do, lse, delta)
    dq, _, _, _ = _bwd_outputs(q, k, v, bias, True, False)
    _launch("flash_bwd_dq", "flash_bwd_dq_launch", q, k, v, bias,
            (do, lse, delta, dq), causal, sm_scale)
    flash_bwd_dq.launches += 1
    return dq


def flash_small_bwd(q, k, v, bias, do, lse, delta, causal=False,
                    sm_scale=1.0):
    """Short-sequence backward in one launch (replaces `_small_bwd_kernel`).
    Arguments as `flash_bwd_dkv`; returns (dq, dk, dv, db)."""
    if q.device.type == "cpu":
        return flash_small_bwd_plain(q, k, v, bias, do, lse, delta, causal,
                                     sm_scale)
    _no_kernel("flash_small_bwd", q)
    _check_bwd_args("flash_small_bwd", q, k, v, bias, do, lse, delta)
    outs = _bwd_outputs(q, k, v, bias, True, True)
    _launch("flash_small_bwd", "flash_small_bwd_launch", q, k, v, bias,
            (do, lse, delta) + outs, causal, sm_scale)
    flash_small_bwd.launches += 1
    return outs


def tiled_body(name: str, d: int, dtype):
    """(blocks an SM holds, tensor cores) of the kernel that `name`
    ("flash_fwd", "flash_bwd_dkv" or "flash_bwd_dq") launches at head dim d
    and dtype on the current card: the blocks from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, and whether the library
    picks a tensor-core body (csrc/flash_fwd_tc.cuh, csrc/flash_bwd_tc.cuh)
    rather than the FMA body (csrc/flash_fwd_body.cuh,
    csrc/flash_bwd_common.cuh). Both come from the library, which alone
    holds the rule."""
    from .cuda_build import load_library
    fn = getattr(load_library(name), f"{name}_blocks_per_sm")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    tensor_cores = ctypes.c_int(-1)
    n = fn(d, int(dtype == torch.bfloat16), ctypes.byref(tensor_cores))
    if n <= 0:
        raise RuntimeError(f"{name}: occupancy query failed ({n})")
    return n, bool(tensor_cores.value)


flash_fwd.launches = 0
flash_small_fwd.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0
flash_small_bwd.launches = 0


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


def _flash_bwd(q, k, v, bias, o, lse, do, causal, sm_scale):
    """(b, s, n, d) in -> (dq, dk, dv, db) through the backward kernel(s)
    the JAX package would pick for these shapes (:653); the kernels work
    from the saved o and lse, with no forward replay. db, when a per-key
    bias is given, is summed over heads into the bias's own shape."""
    b, sq, n, d = q.shape
    sk = k.shape[1]
    bb = None if bias is None else _bias_to_bn(bias, b, n, sk)
    q_bn, k_bn, v_bn = _to_bn(q), _to_bn(k), _to_bn(v)
    do_bn = _to_bn(do.to(q.dtype))
    delta = torch.sum(do_bn.float() * _to_bn(o).float(), dim=-1)
    args = (q_bn, k_bn, v_bn, bb, do_bn, lse, delta, causal, sm_scale)
    if _small_ok(sq, sk):
        dq, dk, dv, db_bn = flash_small_bwd(*args)
    else:
        dk, dv, db_bn = flash_bwd_dkv(*args)
        dq = flash_bwd_dq(*args)
    db = None
    if bias is not None:
        db = db_bn.reshape(b, n, sk).sum(dim=1).reshape(bias.shape) \
            .to(bias.dtype)
    return _from_bn(dq, b, n), _from_bn(dk, b, n), _from_bn(dv, b, n), db


class _FlashAttention(torch.autograd.Function):
    """The flash forward with the flash backward as its gradient (JAX:
    `flash_attention`, a custom_vjp, :633). In the setup_context form, so
    torch.func transforms can go through it too. Lse is an output only so
    that setup_context can save it; it has no gradient."""

    @staticmethod
    def forward(q, k, v, bias, causal, sm_scale):
        return _flash_fwd(q, k, v, bias, causal, sm_scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, bias, causal, sm_scale = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv, db = _flash_bwd(q, k, v, bias, o, lse, do, ctx.causal,
                                    ctx.sm_scale)
        return dq, dk, dv, db, None, None


def flash_attention(q, k, v, bias, causal: bool, sm_scale: float):
    """Flash attention with gradients for q, k, v and the per-key bias.
    q: (b, sq, n, d); k/v: (b, sk, n, d); bias: (b, sk) / (b, 1, 1, sk) or
    None. Returns (b, sq, n, d)."""
    return _FlashAttention.apply(q, k, v, bias, causal, sm_scale)[0]


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
    """Dispatching fused attention, differentiable on both paths. impl:
    None (auto) | 'flash' | 'xla' (the plain reference)."""
    if sm_scale is None:
        sm_scale = 1.0 / np.sqrt(q.shape[-1])
    use_flash, _ = flash_dispatch(q, k, bias, impl)
    if use_flash:
        return flash_attention(q, k, v, bias, causal, float(sm_scale))
    return mha_reference(q, k, v, bias, causal, sm_scale)


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


def attention_bwd_saved(q, k, v, bias, out, lse, g, causal: bool,
                        sm_scale: Optional[float] = None,
                        impl: Optional[str] = None):
    """Flash backward from the saved (out, lse), with no forward recompute
    (JAX :742). Only valid when the forward's flash_dispatch said
    use_flash. Returns (dq, dk, dv) in the (b, s, n, d) layout."""
    if sm_scale is None:
        sm_scale = 1.0 / np.sqrt(q.shape[-1])
    dq, dk, dv, _ = _flash_bwd(q, k, v, bias, out, lse, g, causal,
                               float(sm_scale))
    return dq, dk, dv
