"""The summation order of dscale and dbias in the Hopper `residual_ln_bwd`
kernel (`paddle_tpu_torch/ops/csrc/residual_ln_bwd.cu`), emulated in
float32 on the CPU, against the plain version and the JAX spike's Pallas
backward run in interpret mode.

The kernel's order (the source note):

  * xhat = ((x + r) - mu) * rstd and g * xhat per value, each operation
    rounded to f32;
  * warp w of block b takes rows b * 8 + w, + 8 * nblocks, ... and sums
    each column over them in that order, from 0 (per-warp sums in shared
    memory);
  * the block adds its 8 warps' sums in warp order: one partial row;
  * the finalize: warp w of a finalize block sums partial rows w, w + 8,
    ... in order, then the 8 warp sums in warp order.

`nblocks` is the library's grid, `residual_ln_bwd_config`: at (16384, 768)
bf16 on an H100 it is 264 (two blocks of 8 warps on each of 132 SMs; the
`ln_kernel` records of `chip_smoke.py` print it). The emulated sums are held
to LN_SUM_RTOL of their largest value (the tolerance `chip_smoke.py` holds
the kernel to on the card) against the plain version and the JAX kernel's,
which sums 256-row blocks in another order.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from paddle_tpu_torch.tools import spike_residual_ln as srl

LN_SUM_RTOL = 1e-4      # chip_smoke.py: dscale, dbias against the plain
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_spike(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "jax_spike_residual_ln_order",
        os.path.join(_ROOT, "tools", "spike_residual_ln.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emulated_sums(x, r, mu, rstd, g, nblocks):
    """(dscale, dbias) in the kernel's order; x, r, g (M, H) in their own
    dtype, mu, rstd (M, 1) f32."""
    m, h = x.shape
    stride = 8 * nblocks
    iters = -(-m // stride)
    xhat = ((x.float() + r.float()) - mu) * rstd
    gf = g.float()
    sums = []
    for v in (gf * xhat, gf):
        vp = torch.zeros(iters * stride, h)
        vp[:m] = v
        vp = vp.view(iters, nblocks, 8, h)     # row = i * stride + 8 b + w
        warp = torch.zeros(nblocks, 8, h)
        for i in range(iters):
            warp = warp + vp[i]
        part = warp[:, 0]
        for w in range(1, 8):
            part = part + warp[:, w]           # (nblocks, H)
        fin = torch.zeros(8, h)
        for p in range(nblocks):
            fin[p % 8] = fin[p % 8] + part[p]
        total = torch.zeros(h)
        for w in range(8):
            total = total + fin[w]
        sums.append(total)
    return sums


def _inputs(m, h, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(m, h).astype(np.float32),
            rng.randn(m, h).astype(np.float32),
            rng.rand(h).astype(np.float32), rng.rand(h).astype(np.float32),
            rng.randn(m, h).astype(np.float32)]


def _rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_emulated_order_at_bert_base_shape(jax_spike):
    """(16384, 768) bf16, 264 blocks: within LN_SUM_RTOL of the plain
    version's and of the JAX kernel's sums."""
    m, h = srl.SHAPES[0]
    x, r, sc, b, g = _inputs(m, h, seed=16)
    tx, tr, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, r, g))
    tsc, tb = torch.from_numpy(sc), torch.from_numpy(b)
    _, mu, rstd = srl.residual_ln_fwd_plain(tx, tr, tsc, tb)
    _, pdsc, pdb = srl.residual_ln_bwd_plain(tx, tr, tsc, mu, rstd, tg)
    edsc, edb = emulated_sums(tx, tr, mu, rstd, tg, nblocks=264)
    fused = jax_spike._make_fused()
    jx, jr, jg = (jnp.asarray(a, jnp.bfloat16) for a in (x, r, g))
    _, res = fused.fwd(jx, jr, jnp.asarray(sc), jnp.asarray(b))
    _, _, jdsc, jdb = fused.bwd(res, jg)
    for got, plain, ref in ((edsc, pdsc, jdsc), (edb, pdb, jdb)):
        assert got.shape == (h,) and bool(torch.isfinite(got).all())
        assert _rel_to_max(got, plain) <= LN_SUM_RTOL
        assert _rel_to_max(got, np.asarray(ref, np.float32).reshape(h)) \
            <= LN_SUM_RTOL


@pytest.mark.parametrize("m,h,dtype,nblocks", [
    (1000, 1023, torch.float32, 125), (1000, 770, torch.bfloat16, 125),
    (16384, 200, torch.float32, 528), (1, 768, torch.bfloat16, 1),
    (131072, 64, torch.bfloat16, 264)])
def test_emulated_order_on_other_shapes(m, h, dtype, nblocks):
    """Odd H and H % 8 != 0 (the one-value and pair loads), grids other
    than 264, one row, and many rows a warp."""
    x, r, sc, b, g = _inputs(m, h, seed=m + h)
    tx, tr, tg = (torch.from_numpy(a).to(dtype) for a in (x, r, g))
    tsc, tb = torch.from_numpy(sc), torch.from_numpy(b)
    _, mu, rstd = srl.residual_ln_fwd_plain(tx, tr, tsc, tb)
    _, pdsc, pdb = srl.residual_ln_bwd_plain(tx, tr, tsc, mu, rstd, tg)
    edsc, edb = emulated_sums(tx, tr, mu, rstd, tg, nblocks)
    assert _rel_to_max(edsc, pdsc) <= LN_SUM_RTOL
    assert _rel_to_max(edb, pdb) <= LN_SUM_RTOL


def test_emulation_is_exact_on_integers():
    """Small integers sum exactly in any order: the emulation visits every
    row once (M not a multiple of the 8 * nblocks rows a sweep takes)."""
    rng = np.random.RandomState(1)
    g = torch.from_numpy(rng.randint(-3, 4, size=(5000, 96))
                         .astype(np.float32))
    x = torch.from_numpy(rng.randint(-3, 4, size=(5000, 96))
                         .astype(np.float32))
    zero, one = torch.zeros(5000, 1), torch.ones(5000, 1)
    dsc, db = emulated_sums(x, torch.zeros_like(x), zero, one, g, 264)
    assert torch.equal(dsc, (g * x).sum(0)) and torch.equal(db, g.sum(0))
