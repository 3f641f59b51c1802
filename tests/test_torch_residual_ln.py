"""The residual + LayerNorm spike of the PyTorch port
(`paddle_tpu_torch/tools/spike_residual_ln.py`) against the JAX spike
(`tools/spike_residual_ln.py`), on the CPU.

  * the plain versions of the two kernels against the JAX spike's Pallas
    kernels run in interpret mode (`_make_fused(bm=8)`, with
    `pallas_call` patched to interpret=True), at (32, 128) and (64, 200):
    out, mu, rstd and ds within 1e-5 (atol and rtol) in f32, and a bf16 out
    or ds within 1e-5 + one bf16 ulp (2^-7) relative; dscale and dbias,
    sums over the rows, within 1e-5 + 1e-5 relative;
  * `fused_ln`'s autograd gradients against jax.grad of the JAX `xla_ln`;
  * the wrappers run the plain versions on CPU tensors and raise on any
    device that is neither CPU nor CUDA. `chip_smoke.py` holds the kernels
    against the plain versions on the card.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from paddle_tpu_torch.tools import spike_residual_ln as srl
from torch_port_common import one_torch_thread  # noqa: F401


TOL = 1e-5
BF16_ULP = 2.0 ** -7
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_spike():
    spec = importlib.util.spec_from_file_location(
        "jax_spike_residual_ln",
        os.path.join(_ROOT, "tools", "spike_residual_ln.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_spike(monkeypatch):
    """The JAX spike module with its Pallas kernels in interpret mode (it
    looks `pl.pallas_call` up when it calls it)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return _jax_spike()


def _inputs(m, h, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, h).astype(np.float32),
            rng.randn(m, h).astype(np.float32),
            rng.rand(h).astype(np.float32), rng.rand(h).astype(np.float32),
            rng.randn(m, h).astype(np.float32))


_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(got, want, low_precision):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL,
                               rtol=BF16_ULP if low_precision else TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,h", [(32, 128), (64, 200)])
def test_plain_versions_match_jax_kernels(jax_spike, m, h, dtype):
    tdt, jdt = _DT[dtype]
    x, r, sc, b, g = _inputs(m, h, seed=m + h)
    jx, jr, jg = (jnp.asarray(a, jdt) for a in (x, r, g))
    fused = jax_spike._make_fused(bm=8)
    # the JAX custom_vjp's forward rule and backward rule
    jout, res = fused.fwd(jx, jr, jnp.asarray(sc), jnp.asarray(b))
    jds, jds2, jdsc, jdb = fused.bwd(res, jg)
    tx, tr, tg = (torch.from_numpy(a).to(tdt) for a in (x, r, g))
    tsc, tb = torch.from_numpy(sc), torch.from_numpy(b)
    out, mu, rstd = srl.residual_ln_fwd_plain(tx, tr, tsc, tb)
    assert out.dtype == tdt and mu.shape == rstd.shape == (m, 1)
    low = dtype == "bfloat16"
    _close(out.float(), jout, low)
    _close(mu, res[3], False)
    _close(rstd, res[4], False)
    ds, dsc, db = srl.residual_ln_bwd_plain(tx, tr, tsc, mu, rstd, tg)
    assert ds.dtype == tdt and dsc.dtype == db.dtype == torch.float32
    _close(ds.float(), jds, low)
    np.testing.assert_array_equal(np.asarray(jds, np.float32),
                                  np.asarray(jds2, np.float32))
    _close(dsc, jdsc, False)
    _close(db, jdb, False)


@pytest.mark.parametrize("m,h", [(32, 128), (64, 200)])
def test_fused_ln_autograd_matches_jax_grad(jax_spike, m, h):
    """f32: the output within 1e-5 of `xla_ln`, and the gradients of
    sum(fused_ln) for x, r, scale and bias within 1e-5 + 1e-4 relative of
    jax.grad of sum(xla_ln) (the gradients of scale and bias are sums over
    the rows, taken in another order)."""
    x, r, sc, b, _ = _inputs(m, h, seed=7 * m + h)

    def loss(x, r, sc, b):
        return jnp.sum(jax_spike.xla_ln(x, r, sc, b).astype(jnp.float32))

    jins = [jnp.asarray(a) for a in (x, r, sc, b)]
    jgrads = jax.grad(loss, argnums=(0, 1, 2, 3))(*jins)
    tins = [torch.from_numpy(a).requires_grad_() for a in (x, r, sc, b)]
    out = srl.fused_ln(*tins)
    _close(out.detach(), jax_spike.xla_ln(*jins), False)
    tgrads = torch.autograd.grad(out.float().sum(), tins)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL,
                                   rtol=1e-4)


def test_torch_ln_matches_xla_ln(jax_spike):
    x, r, sc, b, _ = _inputs(16, 96, seed=3)
    want = jax_spike.xla_ln(*(jnp.asarray(a) for a in (x, r, sc, b)))
    got = srl.torch_ln(*(torch.from_numpy(a) for a in (x, r, sc, b)))
    _close(got, want, False)


def test_wrappers_take_plain_path_on_cpu_and_raise_elsewhere():
    x, r, sc, b, g = (torch.from_numpy(a) for a in _inputs(8, 24, seed=1))
    out, mu, rstd = srl.residual_ln_fwd(x, r, sc, b)
    ref = srl.residual_ln_fwd_plain(x, r, sc, b)
    for a, want in zip((out, mu, rstd), ref):
        assert torch.equal(a, want)
    ds, dsc, db = srl.residual_ln_bwd(x, r, sc, mu, rstd, g)
    for a, want in zip((ds, dsc, db),
                       srl.residual_ln_bwd_plain(x, r, sc, mu, rstd, g)):
        assert torch.equal(a, want)
    assert srl.residual_ln_fwd.launches == srl.residual_ln_bwd.launches == 0
    meta = [t.to("meta") for t in (x, r, sc, b, g)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        srl.residual_ln_fwd(*meta[:4])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        srl.residual_ln_bwd(meta[0], meta[1], meta[2], mu.to("meta"),
                            rstd.to("meta"), meta[4])


def test_bound_bytes_at_bert_base_shape():
    """At (16384, 768) bf16: 75.6 MB forward, 100.8 MB backward."""
    fwd, bwd = srl.bound_bytes(16384, 768, 2)
    assert round(fwd / 1e6, 1) == 75.6 and round(bwd / 1e6, 1) == 100.8

