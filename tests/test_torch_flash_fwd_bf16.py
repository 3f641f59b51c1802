"""The tiled flash forward in bf16: the port's plain version against the JAX
package's `_fwd_kernel`.

The reference's tiled forward (`_flash_call`, run here in interpret mode as
tests/test_attention.py runs it) keeps a running max m over k-blocks of
`_pick_blocks` keys (512, or 128 where sk is not a multiple of 512) and
rounds each block's unnormalised p = exp(s - m) to v's dtype before P.V,
summing l from the unrounded f32 p (flash_attention.py:106-111).
`flash_fwd_plain` does the same, so its bf16 O agrees within 2e-5 plus one
bf16 ulp of O, plus one rounding step of each p within 2^-16 of a bf16 tie
times |V|, rescaled as its block's accumulator is and divided by l
(chip_smoke's `tie_slack_tiled`: XLA's and torch's f32 scores differ in
their last bits, so such a p may round apart). The earlier arithmetic, p
kept in f32 over 64-key tiles, puts several per cent of O outside that
bound, which the last assertion shows.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import FP32_TOL, tie_slack_tiled
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa

BF16 = torch.bfloat16


def _bf16_ulp(x):
    """One bf16 ulp of each element of x (f32 tensor)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(1e-30)))
    return torch.exp2(e - 7)


def _inputs(bn, s, d, seed, frac):
    """bf16 q, k, v from numpy and a (bn, s) per-key bias masking `frac` of
    the keys with -1e4."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(bn, s, d).astype(np.float32))
               .to(BF16) for _ in range(3))
    bias = torch.from_numpy(((rng.rand(bn, s) < frac) * -1e4)
                            .astype(np.float32))
    return q, k, v, bias


def _jnp(t):
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


def _f32_p_over_64_key_tiles(q, k, v, bias, causal, sm):
    """The arithmetic flash_fwd_plain had before it followed the
    reference's rounding point: p in f32 over 64-key tiles."""
    bn, sq, d = q.shape
    m = torch.full((bn, sq), -1e30)
    l = torch.zeros((bn, sq))
    acc = torch.zeros((bn, sq, d))
    for k0 in range(0, k.shape[1], 64):
        s = tfa._masked_scores(q, k[:, k0:k0 + 64], bias, causal, sm, 0, k0)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ v[:, k0:k0 + 64].float()
        m = m_new
    return (acc / l[..., None]).to(q.dtype)


# (s, causal, masked fraction): 640 steps over 128-key blocks, 1024 over
# 512-key blocks; bn 2 and d 64 run in seconds in interpret mode
_CASES = [(s, causal, frac) for s, frac in ((640, 0.1), (1024, 0.25))
          for causal in (False, True)]


@pytest.mark.parametrize("s,causal,frac", _CASES)
def test_tiled_fwd_plain_matches_jax_bf16(s, causal, frac):
    q, k, v, bias = _inputs(2, s, 64, seed=s + causal, frac=frac)
    sm = 64 ** -0.5
    o_j, lse_j = jfa._flash_call(_jnp(q), _jnp(k), _jnp(v), _jnp(bias),
                                 causal, sm, True)
    o_j, lse_j = _np(o_j), _np(lse_j)[:, :s, 0]
    o, lse = tfa.flash_fwd_plain(q, k, v, bias, causal, sm)
    assert o.dtype == BF16 and lse.dtype == torch.float32
    bound = FP32_TOL + _bf16_ulp(o_j) + tie_slack_tiled(
        q, k, v, bias, causal, sm)
    err = (o.float() - o_j).abs()
    assert bool((err <= bound).all()), (
        f"{int((err > bound).sum())} of {err.numel()} elements, worst "
        f"{err.max().item():.3g}")
    np.testing.assert_allclose(lse.numpy(), lse_j.numpy(), atol=FP32_TOL,
                               rtol=FP32_TOL)

    # the bound has teeth: the old rounding point puts many elements
    # outside it
    old = _f32_p_over_64_key_tiles(q, k, v, bias, causal, sm)
    assert ((old.float() - o_j).abs() > bound).float().mean() > 0.01


def test_block_rule_is_the_reference_rule():
    for sk in (100, 384, 512, 640, 1000, 1024, 1536, 2048, 4096):
        assert tfa.fwd_block_k(sk) == jfa._pick_blocks(sk, sk)[1]
