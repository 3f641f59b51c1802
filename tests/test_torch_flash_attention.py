"""Flash-attention forward of the PyTorch port against the JAX package.

On the CPU each Hopper kernel's wrapper runs its plain PyTorch version; it
is checked here against the JAX package's Pallas kernel run in interpret
mode (`_flash_fwd(..., interpret=True)`, as tests/test_attention.py runs
it), O and lse, to 2e-5 (f32; the summation order differs). The kernels
themselves run only on the card and are held against the same plain
versions by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa

TOL = 2e-5


def _inputs(b, sq, sk, n, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, n, d).astype(np.float32)
    k = rng.randn(b, sk, n, d).astype(np.float32)
    v = rng.randn(b, sk, n, d).astype(np.float32)
    bias = ((rng.rand(b, sk) > 0.9) * -1e4).astype(np.float32)
    return q, k, v, bias


def _jax_flash(q, k, v, bias4, causal, sm):
    o, res = jfa._flash_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                            None if bias4 is None else jnp.asarray(bias4),
                            causal, sm, True)
    sq = q.shape[1]
    return np.asarray(o), np.asarray(res[5])[:, :sq, 0]


# s=256: the single-pass kernel; s=640: the tiled kernel with 128-row JAX
# blocks; s=1024: tiled with 512-row blocks; each causal x bias. Then
# sq != sk without bias: 256x512 single-pass, 384x640 tiled.
_CASES = [(s, s, bias, causal) for s in (256, 640, 1024)
          for bias in (False, True) for causal in (False, True)] + \
         [(sq, sk, False, causal) for sq, sk in ((256, 512), (384, 640))
          for causal in (False, True)]


@pytest.mark.parametrize("sq,sk,with_bias,causal", _CASES)
def test_plain_kernels_match_jax_interpret(sq, sk, with_bias, causal):
    q, k, v, bias = _inputs(1, sq, sk, 2, 32)
    bias4 = bias[:, None, None, :] if with_bias else None
    sm = 1.0 / np.sqrt(32)
    o_ref, lse_ref = _jax_flash(q, k, v, bias4, causal, sm)

    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tb4 = None if bias4 is None else torch.from_numpy(bias4)
    o, lse = tfa._flash_fwd(tq, tk, tv, tb4, causal, sm)
    assert lse.shape == (2, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), o_ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=TOL, rtol=TOL)

    # the plain version the dispatch did not pick computes the same thing
    other = (tfa.flash_fwd_plain if tfa._small_ok(sq, sk)
             else tfa.flash_small_fwd_plain)
    bb = None if tb4 is None else tfa._bias_to_bn(tb4, 1, 2, sk)
    o2, lse2 = other(tfa._to_bn(tq), tfa._to_bn(tk), tfa._to_bn(tv), bb,
                     causal, sm)
    np.testing.assert_allclose(tfa._from_bn(o2, 1, 2).numpy(), o_ref,
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse2.numpy(), lse_ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", [None, "key", "full"])
def test_mha_reference_matches_jax(causal, bias_kind):
    """Top-left causal alignment with sq != sk, -1e30 masking, and a
    general (b, n, sq, sk) bias."""
    q, k, v, bias = _inputs(2, 24, 40, 3, 8, seed=1)
    rng = np.random.RandomState(2)
    b = {None: None, "key": bias[:, None, None, :],
         "full": rng.randn(2, 3, 24, 40).astype(np.float32)}[bias_kind]
    ref = np.asarray(jfa.mha_reference(
        *(jnp.asarray(a) for a in (q, k, v)),
        None if b is None else jnp.asarray(b), causal))
    out = tfa.mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                            None if b is None else torch.from_numpy(b),
                            causal)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", [None, "flash", "xla"])
@pytest.mark.parametrize("shape,bias_kind", [
    ((2, 256, 4, 64), None), ((2, 1024, 4, 64), "key4"),
    ((2, 128, 4, 64), "key2"), ((1, 264, 2, 32), None),
    ((1, 512, 2, 12), None), ((1, 256, 2, 64), "full"),
    ((1, 256, 2, 24), None), ((1, 640, 2, 96), None),
    ((1, 256, 1, 264), None)])
def test_flash_dispatch_matches_jax_on_cpu(impl, shape, bias_kind):
    b, s, n, d = shape
    bias = {None: None, "key2": np.zeros((b, s), np.float32),
            "key4": np.zeros((b, 1, 1, s), np.float32),
            "full": np.zeros((b, n, s, s), np.float32)}[bias_kind]
    q = np.zeros(shape, np.float32)
    jargs = (jnp.asarray(q), jnp.asarray(q),
             None if bias is None else jnp.asarray(bias), impl)
    targs = (torch.from_numpy(q), torch.from_numpy(q),
             None if bias is None else torch.from_numpy(bias), impl)
    if impl == "flash" and bias_kind == "full":
        with pytest.raises(ValueError):
            jfa.flash_dispatch(*jargs)
        with pytest.raises(ValueError):
            tfa.flash_dispatch(*targs)
        return
    assert tfa.flash_dispatch(*targs) == jfa.flash_dispatch(*jargs)


@pytest.mark.parametrize("sq", [256, 640])
def test_attention_fwd_lse_flash_matches_jax(sq):
    q, k, v, bias = _inputs(2, sq, sq, 2, 16, seed=4)
    bias4 = bias[:, None, None, :]
    jo, jlse = jfa.attention_fwd_lse(
        *(jnp.asarray(a) for a in (q, k, v, bias4)), causal=True,
        impl="flash")
    to, tlse = tfa.attention_fwd_lse(
        *(torch.from_numpy(a) for a in (q, k, v, bias4)), causal=True,
        impl="flash")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, :sq, 0],
                               atol=TOL, rtol=TOL)
    # the reference path returns no lse, like JAX's
    assert tfa.attention_fwd_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), impl="xla")[1] is None


def test_wrappers_take_the_plain_version_only_on_cpu():
    q = torch.randn(4, 256, 64)
    before = (tfa.flash_fwd.launches, tfa.flash_small_fwd.launches)
    for fn, plain in ((tfa.flash_fwd, tfa.flash_fwd_plain),
                      (tfa.flash_small_fwd, tfa.flash_small_fwd_plain)):
        o, lse = fn(q, q, q, None, True, 0.125)
        o2, lse2 = plain(q, q, q, None, True, 0.125)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        # no kernel for another device, and no fallback to a plain version
        m = q.to("meta")
        with pytest.raises(ValueError, match="no kernel"):
            fn(m, m, m, None, True, 0.125)
    # the CPU path launches nothing
    assert (tfa.flash_fwd.launches, tfa.flash_small_fwd.launches) == before


def test_fully_masked_rows_stay_finite():
    """A row whose every key is masked gives a finite answer (-1e30 fill,
    not -inf), as in the JAX reference."""
    q, k, v, _ = _inputs(1, 256, 256, 2, 16, seed=5)
    bias = np.full((1, 256), -1e30, np.float32)
    tq, tk, tv = (tfa._to_bn(torch.from_numpy(a)) for a in (q, k, v))
    tb = tfa._bias_to_bn(torch.from_numpy(bias), 1, 2, 256)
    for fn in (tfa.flash_fwd_plain, tfa.flash_small_fwd_plain):
        o, lse = fn(tq, tk, tv, tb, False, 0.25)
        assert torch.isfinite(o).all() and torch.isfinite(lse).all()
