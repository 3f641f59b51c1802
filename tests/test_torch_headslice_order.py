"""The head-slice Gram kernel's tensor-core body, emulated on the CPU.

csrc/headslice_gram.cu runs `headslice_gram` (x (b, s, n, d) f32, out
(b, s, s) f32) on wgmma m64n64k8 TF32 with the split of the tiled flash
kernels (csrc/flash_bwd_tc.cuh): x = hi + lo, hi rounded to TF32 and lo the
rest as the tensor cores read it, and for each k-step of 8 columns of d, in
order, acc += lo_i.hi_j + hi_i.lo_j + hi_i.hi_j into f32 accumulators. An
output's sum does not depend on the tile it lies in, so the emulation walks
the whole (s, s) matrix k-step by k-step. The body computes only tiles
ti <= tj and stores each as itself and as its transpose (a diagonal tile
its upper half and that half's mirror): the emulated result is the upper
triangle mirrored, bitwise symmetric.

Held here, at the repro's shape and at GPT_SHAPE, on x ~ U(0, 1) from numpy:
the emulation within chip_smoke.py's unchanged GRAM_TOL (2e-5 atol and
rtol) of the plain version; one TF32 product a k-step misses that
tolerance (so the three products are needed); the tile walk twin
(`mosaic_repro_headslice.tile_walk`) writes each output element exactly
once.
"""

import numpy as np
import pytest
import torch

from chip_smoke import GRAM_TOL
from paddle_tpu_torch.tools import mosaic_repro_headslice as mrh
from test_torch_flash_bwd_split import split, tf32

KSTEP = 8               # depth of a TF32 wgmma (m64n64k8)


def emulated_gram(x, three=True, mirror=True):
    """The tensor-core body's result for x (b, s, n, d): the last head's
    slice padded to a multiple of 8 columns (TMA's zero fill), then k-step
    by k-step in order acc += lo.hi^T + hi.lo^T + hi.hi^T (each product an
    f32 sum of 8 terms), or with three=False one TF32 product; then the
    upper triangle mirrored (mirror=False: the whole accumulator)."""
    xs = x[:, :, -1].float()
    d = xs.shape[-1]
    xs = torch.nn.functional.pad(xs, (0, -d % KSTEP))
    hi, lo = split(xs)
    b, s, dp = xs.shape
    acc = torch.zeros((b, s, s))
    for k0 in range(0, dp, KSTEP):
        h, l = hi[..., k0:k0 + KSTEP], lo[..., k0:k0 + KSTEP]
        if three:
            acc = acc + l @ h.transpose(1, 2)
            acc = acc + h @ l.transpose(1, 2)
            acc = acc + h @ h.transpose(1, 2)
        else:
            t = tf32(xs[..., k0:k0 + KSTEP])
            acc = acc + t @ t.transpose(1, 2)
    if not mirror:
        return acc
    upper = torch.ones((s, s), dtype=torch.bool).triu()
    return torch.where(upper, acc, acc.transpose(1, 2))


def _x(shape, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(*shape).astype(np.float32))


def _excess(got, want):
    """The largest |got - want| as a fraction of GRAM_TOL's bound."""
    return ((got - want).abs() / (GRAM_TOL + GRAM_TOL * want.abs())).max() \
        .item()


@pytest.mark.parametrize("shape", [mrh.SHAPE, mrh.GPT_SHAPE, (2, 200, 6, 40)])
def test_split_tf32_holds_gram_tol(shape):
    x = _x(shape)
    got = emulated_gram(x)
    assert got.shape == (shape[0], shape[1], shape[1])
    assert _excess(got, mrh.headslice_gram_plain(x)) <= 1.0


@pytest.mark.parametrize("shape", [mrh.SHAPE, mrh.GPT_SHAPE])
def test_one_tf32_product_misses_gram_tol(shape):
    x = _x(shape)
    assert _excess(emulated_gram(x, three=False),
                   mrh.headslice_gram_plain(x)) > 1.0


@pytest.mark.parametrize("shape", [mrh.SHAPE, mrh.GPT_SHAPE])
def test_emulated_result_is_bitwise_symmetric(shape):
    got = emulated_gram(_x(shape, seed=1))
    assert torch.equal(got, got.transpose(1, 2))
    # the whole accumulator is not: acc_ij adds lo_i.hi_j, then hi_i.lo_j
    # and acc_ji the same two terms in the other order
    acc = emulated_gram(_x(shape, seed=1), mirror=False)
    assert not torch.equal(acc, acc.transpose(1, 2))


def _writes(b, s):
    """How many times the tensor-core body's blocks, as `tile_walk` orders
    them, write each output element: a tile at (ti, tj) and its transpose
    at (tj, ti); a diagonal tile its upper half and that half's mirror."""
    t = mrh.TC_TILE
    count = np.zeros((b, s, s), dtype=np.int64)
    for batch, ti, tj in mrh.tile_walk(b, s):
        rows = np.arange(ti * t, min(s, ti * t + t))
        cols = np.arange(tj * t, min(s, tj * t + t))
        if ti == tj:
            upper = rows[:, None] <= cols[None, :]
            count[batch, rows[:, None], cols[None, :]] += upper
            count[batch, cols[None, :], rows[:, None]] += upper & (
                rows[:, None] != cols[None, :])
        else:
            count[batch, rows[:, None], cols[None, :]] += 1
            count[batch, cols[:, None], rows[None, :]] += 1
    return count


@pytest.mark.parametrize("s", [99, 128, 200, 1000, 1024])
def test_tile_walk_writes_each_element_once(s):
    b = 2
    walk = mrh.tile_walk(b, s)
    nt = -(-s // mrh.TC_TILE)
    assert len(walk) == b * nt * (nt + 1) // 2
    assert all(ti <= tj for _, ti, tj in walk)
    assert (_writes(b, s) == 1).all()
    # the walk is the tensor-core body's: s % 4 == 0 goes there
    strides = (s * 12 * 64, 12 * 64, 64, 1)
    assert mrh.route(b, s, 12, 64, strides, 0) == (
        "tc" if s % 4 == 0 else "simt")
