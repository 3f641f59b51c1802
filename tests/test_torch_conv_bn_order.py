"""The summation order of the Hopper `conv_bn_stats` kernel
(`paddle_tpu_torch/ops/csrc/conv_bn_stats.cu`), emulated in float32 on the
CPU, against the plain version and the JAX spike's Pallas kernel run in
interpret mode.

The kernel takes the column sums s and q of the f32 product y = x @ w from
its accumulator registers in a fixed order (the source note):

  * each thread adds its two rows of a tile (r and r + 8; q as a*a + b*b,
    no fused multiply-add);
  * the eight lanes g = 0..7 that share a column reduce it in pairs
    (g, g ^ 4), then (g, g ^ 2), then (g, g ^ 1): a warp's 16 rows;
  * the four warps of a warpgroup in order, then warpgroup 0 + warpgroup 1:
    the tile's 128 rows;
  * a persistent block's tiles in walk order (row blocks pr, pr + rows,
    ... of its column block, from 0);
  * the finalize: warp w of a finalize block sums partial rows w, w + 8,
    ... in order, then the 8 warp sums in warp order.

At the spike's deepest shape, (6144, 2048, 512) on an H100's 132 SMs, the
library picks 128-wide tiles, a grid of 132 and 33 partial rows (the
`conv_bn_kernel` records of `chip_smoke.py` print its choice). The
emulated sums are held to CBN_SUM_RTOL of their largest value (the
tolerance `chip_smoke.py` holds the kernel to on the card) against the
plain version and against the JAX kernel's, which sums its 512-row blocks
in another order. The product itself runs on the tensor cores in an order
the CPU cannot follow, so y comes from the plain f32 product here.
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.tools import spike_conv_bn as scb
from torch_port_common import one_torch_thread  # noqa: F401


CBN_SUM_RTOL = 1e-4     # chip_smoke.py: s and q against the plain version
H100_SMS = 132
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_ROOT, "paddle_tpu_torch", "ops", "csrc")


def _jax_spike():
    spec = importlib.util.spec_from_file_location(
        "jax_spike_conv_bn_order",
        os.path.join(_ROOT, "tools", "spike_conv_bn.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tile_n(c):
    """The library's tile width (`pick_tile`)."""
    return 64 if c <= 64 else 128


def emulated_stats(y, sms=H100_SMS):
    """(s, q) of the f32 product y (M, C) in the kernel's order."""
    m, c = y.shape
    bn = _tile_n(c)
    col_blocks, row_blocks = -(-c // bn), -(-m // 128)
    rows = min(row_blocks, max(1, sms // col_blocks))
    yp = torch.zeros(row_blocks * 128, col_blocks * bn, dtype=torch.float32)
    yp[:m, :c] = y
    # (row block, warpgroup, warp, r or r + 8, g, column)
    t = yp.view(row_blocks, 2, 4, 2, 8, -1)
    a, b = t[:, :, :, 0], t[:, :, :, 1]
    out = []
    for v in (a + b, a * a + b * b):
        v = v[..., 0:4, :] + v[..., 4:8, :]        # g + (g ^ 4)
        v = v[..., 0:2, :] + v[..., 2:4, :]        # then g ^ 2
        warp = v[..., 0, :] + v[..., 1, :]         # then g ^ 1
        wg = ((warp[:, :, 0] + warp[:, :, 1]) + warp[:, :, 2]) \
            + warp[:, :, 3]
        tile = wg[:, 0] + wg[:, 1]                 # (row block, column)
        run = torch.zeros(rows, tile.shape[1])
        for i in range(-(-row_blocks // rows)):
            rb = torch.arange(rows) + i * rows
            ok = rb < row_blocks
            run[ok] = run[ok] + tile[rb[ok]]
        warps = torch.zeros(8, tile.shape[1])
        for p in range(rows):
            warps[p % 8] = warps[p % 8] + run[p]
        total = torch.zeros(tile.shape[1])
        for w in range(8):
            total = total + warps[w]
        out.append(total[:c])
    return out


def _inputs(m, k, c, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 0.1).astype(np.float32)
    w = (rng.randn(k, c) * 0.05).astype(np.float32)
    return (torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(w).to(torch.bfloat16), x, w)


def _rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_emulated_order_at_deepest_spike_shape():
    """(6144, 2048, 512): the emulated s and q against the plain version
    and the JAX kernel (interpret mode), within CBN_SUM_RTOL of max."""
    m, k, c = scb.SHAPES[-1]
    tx, tw, x, w = _inputs(m, k, c, seed=8)
    y, ps, pq = scb.fused_conv_bn_stats_plain(tx, tw)
    es, eq = emulated_stats(tx.float() @ tw.float())
    jax_spike = _jax_spike()
    _, js, jq = jax_spike.fused_conv_bn_stats(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        interpret=True)
    for got, plain, ref in ((es, ps, js), (eq, pq, jq)):
        assert got.shape == (c,) and bool(torch.isfinite(got).all())
        assert _rel_to_max(got, plain) <= CBN_SUM_RTOL
        assert _rel_to_max(got, ref) <= CBN_SUM_RTOL


@pytest.mark.parametrize("m,k,c", [(1000, 72, 200), (1, 64, 64),
                                   (130, 8, 8), (6272, 64, 256),
                                   (100352, 64, 128)])
def test_emulated_order_on_ragged_and_many_tile_shapes(m, k, c):
    """Ragged M and C (zero rows and columns in the last tiles), one row,
    and shapes whose blocks walk several tiles (100352 rows: 784 row
    blocks over 132 blocks)."""
    tx, tw, _, _ = _inputs(m, k, c, seed=m + c)
    _, ps, pq = scb.fused_conv_bn_stats_plain(tx, tw)
    es, eq = emulated_stats(tx.float() @ tw.float())
    assert _rel_to_max(es, ps) <= CBN_SUM_RTOL
    assert _rel_to_max(eq, pq) <= CBN_SUM_RTOL


def test_emulation_is_exact_on_integers():
    """Small integers sum exactly in any order: the emulation's walk covers
    every row and column once."""
    y = torch.from_numpy(np.random.RandomState(0).randint(
        -4, 5, size=(1000, 200)).astype(np.float32))
    es, eq = emulated_stats(y)
    assert torch.equal(es, y.sum(0)) and torch.equal(eq, (y * y).sum(0))


def _source_with_headers(name):
    """The .cu source and every csrc header it includes, as one text."""
    seen, text, todo = set(), [], [name]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        with open(os.path.join(_CSRC, f)) as fh:
            src = fh.read()
        text.append(src)
        todo += re.findall(r'#include "([\w.]+)"', src)
    return "\n".join(text)


def test_conv_bn_stats_source_uses_wgmma_and_tma():
    """The kernel's products are wgmma's and its operands arrive by TMA
    into an mbarrier ring; its tiles leave by TMA stores."""
    src = _source_with_headers("conv_bn_stats.cu")
    for op in ("wgmma.mma_async", "cp.async.bulk.tensor.2d.shared",
               "cp.async.bulk.tensor.2d.global", "mbarrier.try_wait",
               "setmaxnreg", "cuTensorMapEncodeTiled"):
        assert op in src, op
    # no atomics (atomicAdd, PTX atom. or red.): a rerun gives the same bits
    assert not re.search(r"\batomicAdd\b|\batom\.|\bred\.", src)
