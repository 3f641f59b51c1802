"""The tiled flash backward's tensor-core arithmetic, emulated on the CPU.

csrc/flash_bwd_tc.cuh runs flash_bwd_dkv and flash_bwd_dq in fp32 on the
TF32 tensor cores (mma.sync.m16n8k8). TF32 keeps 10 explicit mantissa bits,
and the reference runs fp32 at "highest" precision, so every product there
is split: x = hi + lo with hi = x rounded to TF32 (to nearest, ties away
from zero, as cvt.rna.tf32.f32 rounds) and lo = x - hi, which the tensor
cores truncate to TF32, and a.b = al.bh + ah.bl + ah.bh accumulated in f32.
This file emulates those bodies in torch (a product of two TF32 values is
exact in f32), with the tiling as built (64-row q-tiles for the key blocks,
64-key tiles for the query blocks, P = 2^((s * scale + bias - lse) log2 e)),
at GPT-2's shape (s 1024, d 64, fp32, causal, with and without a per-key
bias), and holds dK, dV, db and dQ against the plain versions at
chip_smoke.py's unchanged BWD_TOL (atol and rtol). It also shows that the
split keeps 21 bits of an operand and that one unsplit TF32 product does
not hold that tolerance, which is why the kernels pay three products for
each.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import BWD_TOL
from paddle_tpu_torch.ops import flash_attention as tfa

LT = 64                  # rows of a looped tile (csrc tf32::LT)
LOG2E = 1.4426950408889634


def tf32(x):
    """x (f32) rounded to TF32: 10 explicit mantissa bits, to nearest,
    ties away from zero (cvt.rna.tf32.f32)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x):
    """x (f32) as the tensor cores read it: the top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    """The kernels' split: hi rounded to TF32, lo the rest as the tensor
    cores read it."""
    hi = tf32(x)
    return hi, tf32_truncated(x - hi)


def mm3(a, b):
    """a @ b from split operands: al.bh + ah.bl + ah.bh, f32 sums."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    """a @ b as one TF32 product: the precision the split buys back."""
    return tf32(a) @ tf32(b)


def _probs(s, bias_k, lse_q, causal, sm, q0, k0):
    """P = 2^((s * scale + bias - lse) log2 e) under the causal mask, s
    (bn, queries, keys)."""
    x = s * sm
    if bias_k is not None:
        x = x + bias_k[:, None, :]
    if causal:
        rows = torch.arange(q0, q0 + s.shape[1])[:, None]
        cols = torch.arange(k0, k0 + s.shape[2])[None, :]
        x = torch.where(rows >= cols, x, torch.full((), -1e30))
    return torch.exp2((x - lse_q[..., None]) * LOG2E)


def emulated_dkv(q, k, v, bias, do, lse, delta, causal, sm, mm=mm3):
    """tf32::key_block: over 64-row q-tiles, S^T = K.Q^T, dP^T = V.dO^T,
    dV += P^T.dO, dK += dS^T.Q, db += the row sums of dS^T."""
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    db = torch.zeros(k.shape[:2])
    kt = lambda x: x.transpose(-1, -2)
    for q0 in range(0, q.shape[1], LT):
        t = slice(q0, q0 + LT)
        st = mm(k, kt(q[:, t]))
        dpt = mm(v, kt(do[:, t]))
        pt = kt(_probs(kt(st), bias, lse[:, t], causal, sm, q0, 0))
        dst = pt * (dpt - delta[:, None, t])
        dv += mm(pt, do[:, t])
        dk += mm(dst, q[:, t])
        db += dst.sum(dim=2)
    return dk * sm, dv, (db if bias is not None else None)


def emulated_dq(q, k, v, bias, do, lse, delta, causal, sm, mm=mm3):
    """tf32::query_block: over 64-key tiles, S = Q.K^T, dP = dO.V^T,
    dQ += dS.K."""
    dq = torch.zeros(q.shape)
    for k0 in range(0, k.shape[1], LT):
        t = slice(k0, k0 + LT)
        s = mm(q, k[:, t].transpose(-1, -2))
        dp = mm(do, v[:, t].transpose(-1, -2))
        b = None if bias is None else bias[:, t]
        p = _probs(s, b, lse, causal, sm, 0, k0)
        dq += mm(p * (dp - delta[..., None]), k[:, t])
    return dq * sm


def _gpt_inputs(with_bias, seed, bn=2, s=1024, d=64):
    """Two (b*n) rows at GPT-2's attention shape, as chip_smoke's kernel
    cases make them: normal q, k, v, dO; a bias masking 10 % of the keys
    with -1e4; o and lse from the plain forward; delta = rowsum(dO * O)."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(bn, s, d).astype(np.float32))
                   for _ in range(4))
    bias = None
    if with_bias:
        bias = torch.from_numpy(((rng.rand(bn, s) < 0.1) * -1e4)
                                .astype(np.float32))
    sm = d ** -0.5
    o, lse = tfa.flash_small_fwd_plain(q, k, v, bias, True, sm)
    delta = torch.sum(do * o, dim=-1)
    return (q, k, v, bias, do, lse, delta), sm


def _worst(got, ref):
    """The largest |got - ref| / (BWD_TOL + BWD_TOL |ref|): above 1 fails
    chip_smoke's kernel check."""
    return ((got - ref).abs() / (BWD_TOL + BWD_TOL * ref.abs())).max().item()


@pytest.mark.parametrize("with_bias", [False, True])
def test_split_tf32_body_holds_the_kernel_tolerance(with_bias):
    args, sm = _gpt_inputs(with_bias, seed=11 + with_bias)
    dk, dv, db = emulated_dkv(*args, True, sm)
    dq = emulated_dq(*args, True, sm)
    rk, rv, rb = tfa.flash_bwd_dkv_plain(*args, True, sm)
    rq = tfa.flash_bwd_dq_plain(*args, True, sm)
    pairs = [(dk, rk), (dv, rv), (dq, rq)] + (
        [(db, rb)] if with_bias else [])
    for name, (a, b) in zip(("dk", "dv", "dq", "db"), pairs):
        assert bool(torch.isfinite(a).all()), name
        assert _worst(a, b) <= 1.0, (name, _worst(a, b))


def test_one_tf32_product_misses_the_kernel_tolerance():
    args, sm = _gpt_inputs(False, seed=13)
    dk, dv, _ = emulated_dkv(*args, True, sm, mm=mm1)
    dq = emulated_dq(*args, True, sm, mm=mm1)
    rk, rv, _ = tfa.flash_bwd_dkv_plain(*args, True, sm)
    rq = tfa.flash_bwd_dq_plain(*args, True, sm)
    worst = [_worst(a, b) for a, b in ((dk, rk), (dv, rv), (dq, rq))]
    assert min(worst) > 1.0, worst


def test_split_keeps_twenty_one_bits():
    """hi + lo carries an f32 value to within 2^-21 relative, where one
    TF32 rounding keeps 2^-11; a split product, which drops lo.lo, is then
    within 2^-19.5 of the exact one (2^-21 from each operand's lo, 2^-22
    from lo.lo)."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(65536).astype(np.float32)
                         * np.exp2(rng.randint(-20, 20, 65536))
                         .astype(np.float32))
    hi, lo = split(x)
    assert ((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all()
    assert ((hi - x).abs() > 2.0 ** -14 * x.abs()).any()
    # products, in f64 to see the split's own error
    y = x.flip(0)
    yh, yl = split(y)
    three = (hi.double() * yh.double() + hi.double() * yl.double()
             + lo.double() * yh.double())
    exact = x.double() * y.double()
    rel = ((three - exact).abs() / exact.abs()).max().item()
    assert rel <= 2.0 ** -19.5, math.log2(rel)


def test_tf32_rounding_is_to_nearest():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -12, -(1 + 2 ** -11),
                      1 + 2 ** -12, 3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [1 + 2 ** -10, 1 + 2 ** -10,
                                -(1 + 2 ** -10), 1.0, 3.0]
