"""The single-pass flash kernels in bf16: the port's plain versions against
the JAX package, and the tensor-core kernels' arithmetic against the plain
versions.

1. Parity with JAX. `flash_small_fwd_plain` and `flash_small_bwd_plain` on
   bf16 inputs against `_small_call` / `_small_bwd_call` run in interpret
   mode (as tests/test_attention.py runs them), with a per-key bias that
   masks 10-40 % of the keys. The forward rounds P = p / l to bf16 before
   P.V, at the reference's point (`(p / l).astype(v.dtype)`), so O agrees
   within 2e-5 plus one bf16 ulp of O, plus one rounding step of P times
   |V| for the P values within 2^-16 of a bf16 rounding tie
   (chip_smoke's `tie_slack`: XLA's and torch's f32 scores differ in
   their last bits, so such a P may round apart). Rounding P after P.V
   instead puts more than 2 % of O outside that bound. The backward, f32
   throughout as JAX's is, agrees within 1e-4 plus one bf16 ulp.

2. The kernels' numerics. csrc/flash_small_fwd.cu and flash_small_bwd.cu
   compute in an order the plain versions do not: the forward's two passes
   over 64-key chunks (running max and sum, then P = exp(S - m) / l
   rounded to bf16 and multiplied chunk by chunk), and the backward's
   tiles, with P and dS entering every product on the tensor cores as
   hi = bf16(x) plus lo = bf16(x - hi). Emulated here in plain torch at
   BERT-base's head shape, they are held against the plain versions with
   the tolerances chip_smoke.py applies to the kernels on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import BF16_ULP, BWD_TOL, FP32_TOL, tie_slack
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa
from torch_port_common import one_torch_thread  # noqa: F401


BF16 = torch.bfloat16


def _bf16_ulp(x):
    """One bf16 ulp of each element of x (f32 tensor)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(1e-30)))
    return torch.exp2(e - 7)


def _inputs(bn, sq, sk, d, seed, frac=0.25):
    """q, k, v, dO as bf16-representable f32 numpy arrays, and a (bn, sk)
    per-key bias masking `frac` of the keys with -1e4."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(bn, s, d).astype(np.float32) for s in (sq, sk, sk))
    do = rng.randn(bn, sq, d).astype(np.float32)
    bias = ((rng.rand(bn, sk) < frac) * -1e4).astype(np.float32)
    rnd = lambda a: torch.from_numpy(a).to(BF16)
    return rnd(q), rnd(k), rnd(v), rnd(do), torch.from_numpy(bias)


def _jnp(t):
    """A torch tensor as a JAX array of the same dtype."""
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


# (bn, s, causal): the sizes JAX's interpret mode runs in seconds; masked
# fractions from 10 to 40 %
_CASES = [(4, 256, False, 0.1), (4, 256, True, 0.25), (2, 512, False, 0.4),
          (2, 512, True, 0.2)]


@pytest.mark.parametrize("bn,s,causal,frac", _CASES)
def test_small_fwd_plain_matches_jax_bf16(bn, s, causal, frac):
    q, k, v, _, bias = _inputs(bn, s, s, 64, seed=s + bn, frac=frac)
    sm = 64 ** -0.5
    o_j, lse_j = jfa._small_call(_jnp(q), _jnp(k), _jnp(v), _jnp(bias),
                                 causal, sm, True)
    o_j, lse_j = _np(o_j), _np(lse_j)[:, :, 0]
    o, lse = tfa.flash_small_fwd_plain(q, k, v, bias, causal, sm)
    assert o.dtype == BF16 and lse.dtype == torch.float32
    bound = FP32_TOL + _bf16_ulp(o_j) + tie_slack(
        q, k, v, bias, causal, sm)
    err = (o.float() - o_j).abs()
    assert bool((err <= bound).all()), (
        f"{int((err > bound).sum())} of {err.numel()} elements, worst "
        f"{err.max().item():.3g}")
    np.testing.assert_allclose(lse.numpy(), lse_j.numpy(), atol=FP32_TOL,
                               rtol=FP32_TOL)

    # the bound has teeth: P rounded after P.V puts many elements outside
    # it
    s_ = tfa._masked_scores(q, k, bias, causal, sm)
    p = torch.exp(s_ - s_.amax(-1, keepdim=True))
    old = (torch.matmul(p, v.float()) / p.sum(-1, keepdim=True)).to(BF16)
    assert ((old.float() - o_j).abs() > bound).float().mean() > 0.02


@pytest.mark.parametrize("bn,s,causal,frac", _CASES)
def test_small_bwd_plain_matches_jax_bf16(bn, s, causal, frac):
    q, k, v, do, bias = _inputs(bn, s, s, 64, seed=7 * s + bn, frac=frac)
    sm = 64 ** -0.5
    o_j, lse_j = jfa._small_call(_jnp(q), _jnp(k), _jnp(v), _jnp(bias),
                                 causal, sm, True)
    got_j = jfa._small_bwd_call(_jnp(q), _jnp(k), _jnp(v), _jnp(bias), o_j,
                                lse_j, _jnp(do), causal, sm, True)
    # both sides from JAX's saved o and lse
    o_t = _np(o_j).to(BF16)
    lse_t = _np(lse_j)[:, :, 0]
    delta = torch.sum(do.float() * o_t.float(), dim=-1)
    got = tfa.flash_small_bwd_plain(q, k, v, bias, do, lse_t, delta, causal,
                                    sm)
    for name, a, b in zip(("dq", "dk", "dv", "db"), got, got_j):
        b = _np(b)
        a = a.float()
        ulp = _bf16_ulp(b) if name != "db" else 0.0
        err = (a - b).abs()
        bound = BWD_TOL + BWD_TOL * b.abs() + ulp
        assert bool((err <= bound).all()), (
            f"{name}: {int((err > bound).sum())} elements, worst "
            f"{err.max().item():.3g}")


# ---------------------------------------------------------------------------
# the tensor-core kernels' arithmetic, emulated
# ---------------------------------------------------------------------------

_CHUNK = 64   # keys of a forward chunk, rows of a backward tile


def _split(x):
    """x = hi + lo, each bf16: the kernels' two-term split of an f32
    operand."""
    hi = x.to(BF16)
    return hi.float(), (x - hi.float()).to(BF16).float()


def _emulated_fwd(q, k, v, bias, causal, sm):
    """flash_small_fwd.cu's tensor-core body: pass A over 64-key chunks
    keeps the running row max m and sum l; pass B recomputes each chunk's
    scores, rounds P = exp(x - m) / l to bf16 and accumulates P.V in
    f32."""
    bn, sq, _ = q.shape
    sk = k.shape[1]
    m = torch.full((bn, sq), -1e30)
    l = torch.zeros((bn, sq))
    chunks = range(0, sk, _CHUNK)
    for c0 in chunks:
        x = tfa._masked_scores(q, k[:, c0:c0 + _CHUNK], bias, causal, sm,
                               0, c0)
        m_new = torch.maximum(m, x.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(x - m_new[..., None]) \
            .sum(-1)
        m = m_new
    acc = torch.zeros(q.shape)
    for c0 in chunks:
        x = tfa._masked_scores(q, k[:, c0:c0 + _CHUNK], bias, causal, sm,
                               0, c0)
        p = (torch.exp(x - m[..., None]) / l[..., None]).to(BF16).float()
        acc += torch.matmul(p, v[:, c0:c0 + _CHUNK].float())
    return acc.to(q.dtype), m + torch.log(l)


def _emulated_bwd(q, k, v, bias, do, lse, delta, causal, sm):
    """flash_small_bwd.cu's tensor-core body: key blocks over 64-row
    q-tiles (dV, dK, db) and query blocks over 64-key tiles (dQ), with P
    and dS split into bf16 hi + lo for every product."""
    sq, sk = q.shape[1], k.shape[1]
    dk = torch.zeros(k.shape)
    dv = torch.zeros(v.shape)
    db = torch.zeros(k.shape[:2])
    for q0 in range(0, sq, _CHUNK):
        t = slice(q0, q0 + _CHUNK)
        p, ds = tfa._bwd_probs(q[:, t], k, v, bias, do[:, t], lse[:, t],
                               delta[:, t], causal, sm, q0)
        p_hi, p_lo = _split(p.transpose(-1, -2))
        s_hi, s_lo = _split(ds.transpose(-1, -2))
        dv += p_hi @ do[:, t].float() + p_lo @ do[:, t].float()
        dk += s_hi @ q[:, t].float() + s_lo @ q[:, t].float()
        db += ds.sum(dim=1)
    dq = torch.zeros(q.shape)
    for k0 in range(0, sk, _CHUNK):
        t = slice(k0, k0 + _CHUNK)
        _, ds = tfa._bwd_probs(q, k[:, t], v[:, t], bias, do, lse, delta,
                               causal, sm, 0, k0)
        s_hi, s_lo = _split(ds)
        dq += s_hi @ k[:, t].float() + s_lo @ k[:, t].float()
    return ((dq * sm).to(q.dtype), (dk * sm).to(k.dtype), dv.to(v.dtype),
            db)


def _bert_inputs(seed):
    """One batch row of BERT-base's attention: 12 heads, s 512, d 64,
    bf16, the last 30 % of the keys padded (the mask as a per-key
    bias)."""
    torch.manual_seed(seed)
    bn, s, d = 12, 512, 64
    q, k, v, do = (torch.randn(bn, s, d).to(BF16) for _ in range(4))
    bias = torch.zeros(bn, s)
    bias[:, int(0.7 * s):] = -1e4
    return q, k, v, do, bias


@pytest.mark.parametrize("causal", [False, True])
def test_emulated_tensor_core_fwd_within_chip_tolerance(causal):
    q, k, v, _, bias = _bert_inputs(1 + causal)
    sm = 64 ** -0.5
    o, lse = _emulated_fwd(q, k, v, bias, causal, sm)
    o_ref, lse_ref = tfa.flash_small_fwd_plain(q, k, v, bias, causal, sm)
    slack = tie_slack(q, k, v, bias, causal, sm)
    err = (o.float() - o_ref.float()).abs()
    assert bool((err <= FP32_TOL + BF16_ULP * o_ref.float().abs()
                 + slack).all()), err.max().item()
    assert bool(((lse - lse_ref).abs()
                 <= FP32_TOL + FP32_TOL * lse_ref.abs()).all())


@pytest.mark.parametrize("causal", [False, True])
def test_emulated_tensor_core_bwd_within_chip_tolerance(causal):
    q, k, v, do, bias = _bert_inputs(3 + causal)
    sm = 64 ** -0.5
    o, lse = tfa.flash_small_fwd_plain(q, k, v, bias, causal, sm)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, bias, do, lse, delta, causal, sm)
    got = _emulated_bwd(*args)
    ref = tfa.flash_small_bwd_plain(*args)
    for name, a, b in zip(("dq", "dk", "dv", "db"), got, ref):
        a, b = a.float(), b.float()
        rtol = BWD_TOL if name == "db" else BF16_ULP
        err = (a - b).abs()
        assert bool((err <= BWD_TOL + rtol * b.abs()).all()), (
            name, err.max().item())


def test_split_keeps_sixteen_bits():
    """hi + lo carries an f32 value to within 2^-16 relative, where one
    bf16 rounding keeps 2^-8; the backward's products rest on it."""
    x = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32))
    hi, lo = _split(x)
    assert ((hi + lo - x).abs() <= 2.0 ** -16 * x.abs()).all()
    assert ((hi - x).abs() > 2.0 ** -12 * x.abs()).any()
