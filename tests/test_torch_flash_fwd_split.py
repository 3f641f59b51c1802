"""The tiled flash forward's tensor-core bodies, emulated on the CPU.

csrc/flash_fwd_tc.cuh runs `flash_fwd` on the tensor cores in both dtypes:

  * fp32, padded head dim <= 64 (GPT-2's serve and train path): split TF32
    on mma.sync.m16n8k8, every product a.b = al.bh + ah.bl + ah.bh from
    x = hi + lo (hi rounded to TF32, lo the rest as the tensor cores read
    it), accumulated in f32; a one-pass online softmax over 64-key tiles
    with p = 2^((s - m) log2 e). The emulation below (the `tf32`/`split`
    helpers of tests/test_torch_flash_bwd_split.py) holds O and lse at
    GPT-2's shape (s 1024, d 64, causal, with and without a per-key bias)
    to chip_smoke.py's unchanged FP32_TOL against `flash_fwd_plain`, and
    shows that one unsplit TF32 product misses that tolerance.
  * bf16, padded head dim <= 128: wgmma, two passes over each of the
    reference's k-blocks (`fwd_block_k(sk)` keys, walked as 64-key
    chunks): pass A takes the block's row max, the accumulator and l are
    rescaled once, pass B recomputes S, adds the f32 p to l, rounds p to
    bf16 and multiplies it by V (bf16 products are exact in f32, so S and
    P.V are plain f32 sums here). The emulation holds O to FP32_TOL + one
    bf16 ulp of O + chip_smoke's `tie_slack_tiled` and lse to FP32_TOL, at
    sk 1024 (512-key blocks) and sk 640 (128-key blocks).
"""

import numpy as np
import pytest
import torch

from chip_smoke import BF16_ULP, FP32_TOL, tie_slack_tiled
from paddle_tpu_torch.ops import flash_attention as tfa
from test_torch_flash_bwd_split import mm1, mm3
from torch_port_common import one_torch_thread  # noqa: F401


KT = 64                  # keys of a tile or chunk (csrc fwd_tc)
LOG2E = 1.4426950408889634
NEG = -1e30


def _masked(s, bias, causal, sm, k0, sk):
    """The kernels' masked score of a (bn, sq, 64) tile from key k0: scale,
    then the per-key bias, then the causal mask; keys past sk get NEG."""
    x = s * sm
    cols = torch.arange(k0, k0 + s.shape[2])
    if bias is not None:
        x = x + torch.nn.functional.pad(
            bias[:, k0:k0 + s.shape[2]],
            (0, max(0, k0 + s.shape[2] - sk)))[:, None, :]
    keep = (cols < sk)[None, :].expand(s.shape[1], -1)
    if causal:
        keep = keep & (torch.arange(s.shape[1])[:, None] >= cols[None, :])
    return torch.where(keep, x, torch.full((), NEG))


def _tile(x, k0):
    """Keys [k0, k0 + 64) of a (bn, sk, d) tensor, zero past sk (the
    staged tile's zero fill)."""
    t = x[:, k0:k0 + KT].float()
    return torch.nn.functional.pad(t, (0, 0, 0, KT - t.shape[1]))


def _finish(acc, m, l):
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return acc / l[..., None], m + torch.log(l)


def emulated_fwd_f32(q, k, v, bias, causal, sm, mm=mm3):
    """fwd_tc::f32_query_block: over 64-key tiles, S = Q.K^T, the online
    softmax with alpha = 2^((m - m_new) log2 e) and p = 2^((s - m_new)
    log2 e), O += P.V, every product through `mm`. (The kernel skips the
    tiles past a query block's causal diagonal; here they add p = 0 and
    alpha = 1 exactly, so walking them changes no bit.)"""
    bn, sq, d = q.shape
    sk = k.shape[1]
    m = torch.full((bn, sq), NEG)
    l = torch.zeros((bn, sq))
    acc = torch.zeros((bn, sq, d))
    for k0 in range(0, sk, KT):
        kt, vt = _tile(k, k0), _tile(v, k0)
        s = _masked(mm(q, kt.transpose(-1, -2)), bias, causal, sm, k0, sk)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((s - m_new[..., None]) * LOG2E)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + mm(p, vt)
        m = m_new
    return _finish(acc, m, l)


def emulated_fwd_bf16(q, k, v, bias, causal, sm):
    """fwd_tc::bf16_query_block: for each reference block of
    fwd_block_k(sk) keys, pass A over its 64-key chunks takes the row max
    of the masked S, then alpha rescales l and the accumulator once; pass
    B recomputes S chunk by chunk, adds p = 2^((s - m) log2 e) to l in
    f32 and bf16(p).V to the f32 accumulator."""
    bn, sq, d = q.shape
    sk = k.shape[1]
    qf = q.float()
    blk = tfa.fwd_block_k(sk)
    score = lambda k0: _masked(qf @ _tile(k, k0).transpose(-1, -2), bias,
                               causal, sm, k0, sk)
    m = torch.full((bn, sq), NEG)
    l = torch.zeros((bn, sq))
    acc = torch.zeros((bn, sq, d))
    for b0 in range(0, sk, blk):
        chunks = range(b0, min(b0 + blk, sk), KT)
        mb = torch.full((bn, sq), NEG)
        for k0 in chunks:                       # pass A
            mb = torch.maximum(mb, score(k0).amax(dim=-1))
        m_new = torch.maximum(m, mb)
        alpha = torch.exp2((m - m_new) * LOG2E)
        l, acc, m = l * alpha, acc * alpha[..., None], m_new
        for k0 in chunks:                       # pass B
            p = torch.exp2((score(k0) - m[..., None]) * LOG2E)
            l = l + p.sum(dim=-1)
            acc = acc + p.to(torch.bfloat16).float() @ _tile(v, k0)
    o, lse = _finish(acc, m, l)
    return o.to(torch.bfloat16), lse


def _inputs(seed, bn, s, d, with_bias, dtype=torch.float32):
    """q, k, v normal, as chip_smoke's kernel cases make them; a bias
    masking 10 % of the keys with -1e4."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(bn, s, d).astype(np.float32))
               .to(dtype) for _ in range(3))
    bias = None
    if with_bias:
        bias = torch.from_numpy(((rng.rand(bn, s) < 0.1) * -1e4)
                                .astype(np.float32))
    return q, k, v, bias


def _worst(got, ref, rtol=FP32_TOL, slack=0.0):
    """The largest |got - ref| / (FP32_TOL + rtol |ref| + slack): above 1
    fails chip_smoke's kernel check."""
    got, ref = got.float(), ref.float()
    bound = FP32_TOL + rtol * ref.abs() + slack
    return ((got - ref).abs() / bound).max().item()


@pytest.mark.parametrize("with_bias", [False, True])
def test_split_tf32_forward_holds_the_kernel_tolerance(with_bias):
    q, k, v, bias = _inputs(21 + with_bias, 2, 1024, 64, with_bias)
    sm = 64 ** -0.5
    o, lse = emulated_fwd_f32(q, k, v, bias, True, sm)
    ro, rlse = tfa.flash_fwd_plain(q, k, v, bias, True, sm)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    assert _worst(o, ro) <= 1.0, _worst(o, ro)
    assert _worst(lse, rlse) <= 1.0, _worst(lse, rlse)


def test_one_tf32_product_misses_the_forward_tolerance():
    q, k, v, bias = _inputs(23, 2, 1024, 64, False)
    sm = 64 ** -0.5
    o, lse = emulated_fwd_f32(q, k, v, bias, True, sm, mm=mm1)
    ro, rlse = tfa.flash_fwd_plain(q, k, v, bias, True, sm)
    assert max(_worst(o, ro), _worst(lse, rlse)) > 1.0


@pytest.mark.parametrize("s,causal,with_bias", [
    (1024, True, False), (1024, False, True), (640, True, True),
    (640, False, False)])
def test_wgmma_forward_walk_holds_the_kernel_tolerance(s, causal,
                                                       with_bias):
    q, k, v, bias = _inputs(31 + s + 2 * causal + with_bias, 2, s, 64,
                            with_bias, torch.bfloat16)
    sm = 64 ** -0.5
    o, lse = emulated_fwd_bf16(q, k, v, bias, causal, sm)
    ro, rlse = tfa.flash_fwd_plain(q, k, v, bias, causal, sm)
    slack = tie_slack_tiled(q, k, v, bias, causal, sm)
    assert o.dtype == torch.bfloat16 and o.shape == ro.shape
    assert _worst(o, ro, BF16_ULP, slack) <= 1.0
    assert _worst(lse, rlse) <= 1.0, _worst(lse, rlse)

