"""Flash-attention backward of the PyTorch port against the JAX package.

On the CPU each backward kernel's wrapper (`flash_bwd_dkv`, `flash_bwd_dq`,
`flash_small_bwd`) runs its plain PyTorch version; here those are held
against the JAX package's Pallas backward kernels run in interpret mode
(`_flash_bwd(causal, sm, True, res, g)` on the residuals of
`_flash_fwd(..., interpret=True)`, as tests/test_attention.py runs them):
dq, dk, dv and the per-key bias grad db, to 1e-4 atol and rtol in fp32
(the worst measured here is 5.7e-6; the order of the sums differs). The
kernels themselves run only on the card and are held against the same
plain versions by chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa
from torch_port_common import one_torch_thread  # noqa: F401


TOL = 1e-4


def _inputs(b, sq, sk, n, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, n, d).astype(np.float32)
    k = rng.randn(b, sk, n, d).astype(np.float32)
    v = rng.randn(b, sk, n, d).astype(np.float32)
    do = rng.randn(b, sq, n, d).astype(np.float32)
    bias = ((rng.rand(b, sk) > 0.9) * -1e4 + rng.randn(b, sk)) \
        .astype(np.float32)
    return q, k, v, do, bias


def _jax_bwd(q, k, v, bias4, do, causal, sm):
    _, res = jfa._flash_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                            None if bias4 is None else jnp.asarray(bias4),
                            causal, sm, True)
    return [None if g is None else np.asarray(g) for g in
            jfa._flash_bwd(causal, sm, True, res, jnp.asarray(do))]


def _close(got, want):
    if want is None:
        assert got is None
        return
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL,
                               rtol=TOL)


# s=256: the single-pass kernel; s=640 and 1024: the tiled pair; each
# causal x bias. Then sq != sk: 256x512 single-pass, 384x640 tiled.
_CASES = [(s, s, bias, causal) for s in (256, 640, 1024)
          for bias in (False, True) for causal in (False, True)] + \
         [(sq, sk, bias, causal) for sq, sk in ((256, 512), (384, 640))
          for bias, causal in ((False, False), (True, True))]


@pytest.mark.parametrize("sq,sk,with_bias,causal", _CASES)
def test_plain_bwd_kernels_match_jax_interpret(sq, sk, with_bias, causal):
    q, k, v, do, bias = _inputs(1, sq, sk, 2, 32)
    bias4 = bias[:, None, None, :] if with_bias else None
    sm = 1.0 / np.sqrt(32)
    want = _jax_bwd(q, k, v, bias4, do, causal, sm)

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tb4 = None if bias4 is None else torch.from_numpy(bias4)
    o, lse = tfa._flash_fwd(tq, tk, tv, tb4, causal, sm)
    got = tfa._flash_bwd(tq, tk, tv, tb4, o, lse, tdo, causal, sm)
    for g, w in zip(got, want):
        _close(g, w)

    # the plain versions the dispatch did not pick compute the same thing
    bb = None if tb4 is None else tfa._bias_to_bn(tb4, 1, 2, sk)
    args = (tfa._to_bn(tq), tfa._to_bn(tk), tfa._to_bn(tv), bb,
            tfa._to_bn(tdo), lse,
            torch.sum(tfa._to_bn(tdo) * tfa._to_bn(o), dim=-1), causal, sm)
    if tfa._small_ok(sq, sk):
        dk, dv, db = tfa.flash_bwd_dkv_plain(*args)
        dq = tfa.flash_bwd_dq_plain(*args)
    else:
        dq, dk, dv, db = tfa.flash_small_bwd_plain(*args)
    for g, w in zip((dq, dk, dv), want):
        _close(tfa._from_bn(g, 1, 2), w)
    if with_bias:
        _close(db.reshape(1, 2, sk).sum(1).reshape(bias4.shape), want[3])


@pytest.mark.parametrize("sq", [256, 640])
def test_attention_bwd_saved_matches_jax(sq):
    q, k, v, do, bias = _inputs(2, sq, sq, 2, 16, seed=4)
    bias4 = bias[:, None, None, :]
    jq, jk, jv, jdo, jb = (jnp.asarray(a) for a in (q, k, v, do, bias4))
    jo, jlse = jfa.attention_fwd_lse(jq, jk, jv, jb, causal=True,
                                     impl="flash")
    want = jfa.attention_bwd_saved(jq, jk, jv, jb, jo, jlse, jdo, True,
                                   impl="flash")
    tq, tk, tv, tdo, tb = (torch.from_numpy(a) for a in (q, k, v, do, bias4))
    to, tlse = tfa.attention_fwd_lse(tq, tk, tv, tb, causal=True,
                                     impl="flash")
    got = tfa.attention_bwd_saved(tq, tk, tv, tb, to, tlse, tdo, True,
                                  impl="flash")
    for g, w in zip(got, want):
        _close(g, np.asarray(w))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_shape", [None, "b_sk", "b11sk"])
def test_autograd_through_flash_attention_matches_jax_grad(causal,
                                                           bias_shape):
    """torch.autograd.grad through the port's attention(impl="flash") vs
    jax.grad through JAX's, the bias grad (summed over heads) included."""
    q, k, v, w, bias = _inputs(2, 256, 256, 2, 16, seed=6)
    bias = {None: None, "b_sk": bias,
            "b11sk": bias[:, None, None, :]}[bias_shape]

    def jloss(q_, k_, v_, b_):
        out = jfa.attention(q_, k_, v_, b_, causal=causal, impl="flash")
        return jnp.sum(out * jnp.asarray(w))

    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    want = jax.grad(jloss, argnums=argnums)(
        *(jnp.asarray(a) for a in (q, k, v)),
        None if bias is None else jnp.asarray(bias))

    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    if bias is not None:
        ts.append(torch.from_numpy(bias).requires_grad_())
    out = tfa.attention(*ts[:3], ts[3] if bias is not None else None,
                        causal=causal, impl="flash")
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for g, wnt in zip(got, want):
        _close(g, np.asarray(wnt))


def test_flash_attention_under_torch_func():
    """The autograd.Function is in the setup_context form, so torch.func
    transforms go through it and agree with torch.autograd."""
    q, k, v, w, _ = _inputs(1, 256, 256, 2, 16, seed=8)
    tq, tk, tv, tw = (torch.from_numpy(a) for a in (q, k, v, w))
    out, vjp_fn = torch.func.vjp(
        lambda a, b, c: tfa.flash_attention(a, b, c, None, True, 0.25),
        tq, tk, tv)
    got = vjp_fn(tw)
    ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    ref = torch.autograd.grad(
        (tfa.flash_attention(*ts, None, True, 0.25) * tw).sum(), ts)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_bwd_wrappers_take_the_plain_version_only_on_cpu():
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 256, 32, generator=g) for _ in range(4))
    o, lse = tfa.flash_small_fwd_plain(q, k, v, None, True, 0.2)
    delta = torch.sum(do * o, dim=-1)
    args = (q, k, v, None, do, lse, delta, True, 0.2)
    names = ("flash_bwd_dkv", "flash_bwd_dq", "flash_small_bwd")
    before = [getattr(tfa, n).launches for n in names]
    for n in names:
        got = getattr(tfa, n)(*args)
        ref = getattr(tfa, n + "_plain")(*args)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert (a is None and b is None) or torch.equal(a, b)
        # no kernel for another device, and no fallback to a plain version
        m = [t.to("meta") for t in args[:3]]
        with pytest.raises(ValueError, match="no kernel"):
            getattr(tfa, n)(*m, None, *(t.to("meta") for t in args[4:7]),
                            True, 0.2)
    assert [getattr(tfa, n).launches for n in names] == before
