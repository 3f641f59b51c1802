"""The conv + BatchNorm spike of the PyTorch port
(`paddle_tpu_torch/tools/spike_conv_bn.py`) against the JAX spike
(`tools/spike_conv_bn.py`), on the CPU.

  * the plain versions of the two kernels against the JAX spike's Pallas
    kernels run in interpret mode (`pallas_call` patched to interpret=True),
    at (1024, 64, 64) and (1536, 128, 32) in bf16: y and the ReLU output
    within one bf16 ulp (2^-7 relative, 1e-5 absolute: both compute in f32
    and round once, from sums taken in other orders), the column sums s and
    q within 1e-5 of their largest value;
  * fused_block and torch_block against the JAX fused_block and xla_block;
  * the wrappers run the plain versions on CPU tensors and raise on any
    device that is neither CPU nor CUDA; `chip_smoke.py` holds the kernels
    against the plain versions on the card;
  * the bound arithmetic at ResNet-50's shapes.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.tools import spike_conv_bn as scb
from torch_port_common import one_torch_thread  # noqa: F401


BF16_ULP = 2.0 ** -7
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_spike():
    """The JAX spike module; its functions take interpret=True."""
    spec = importlib.util.spec_from_file_location(
        "jax_spike_conv_bn", os.path.join(_ROOT, "tools", "spike_conv_bn.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(m, k, c, seed):
    """The JAX spike's draws (x ~ 0.1 N, w ~ 0.05 N), rounded to bf16 once
    for both packages, and a random gamma and beta."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 0.1).astype(np.float32)
    w = (rng.randn(k, c) * 0.05).astype(np.float32)
    gamma = rng.rand(c).astype(np.float32) + 0.5
    beta = rng.randn(c).astype(np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    return (tx, tw, torch.from_numpy(gamma), torch.from_numpy(beta),
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
            jnp.asarray(gamma), jnp.asarray(beta))


def _f32(a):
    return np.array(a.float() if isinstance(a, torch.Tensor) else a,
                    np.float32)


def _ulp_close(got, want):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5,
                               rtol=BF16_ULP)


def _sum_close(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("m,k,c", [(1024, 64, 64), (1536, 128, 32)])
def test_plain_versions_match_jax_kernels(jax_spike, m, k, c):
    tx, tw, tg, tb, jx, jw, jg, jb = _inputs(m, k, c, seed=m + k + c)
    jy, js, jq = jax_spike.fused_conv_bn_stats(jx, jw, interpret=True)
    y, s, q = scb.fused_conv_bn_stats_plain(tx, tw)
    assert y.dtype == torch.bfloat16 and s.dtype == q.dtype == torch.float32
    assert y.shape == (m, c) and s.shape == q.shape == (c,)
    _ulp_close(y, jy)
    _sum_close(s, js)
    _sum_close(q, jq)
    # the second kernel on the first's JAX outputs, in both packages
    ty = torch.from_numpy(_f32(jy)).to(torch.bfloat16)
    out = scb.bn_apply_relu_plain(ty, torch.from_numpy(_f32(js)),
                                  torch.from_numpy(_f32(jq)), tg, tb,
                                  scb.EPS)
    jout = jax_spike.bn_apply_relu(jy, js, jq, jg, jb, scb.EPS,
                                   interpret=True)
    assert out.dtype == torch.bfloat16 and (_f32(out) >= 0).all()
    _ulp_close(out, jout)


def test_blocks_match_jax(jax_spike):
    """fused_block (the two plain versions on the CPU) against the JAX
    fused_block, and torch_block against xla_block: one bf16 ulp."""
    tx, tw, tg, tb, jx, jw, jg, jb = _inputs(1024, 64, 32, seed=5)
    _ulp_close(scb.fused_block(tx, tw, tg, tb),
               jax_spike.fused_block(jx, jw, jg, jb, interpret=True))
    _ulp_close(scb.torch_block(tx, tw, tg, tb),
               jax_spike.xla_block(jx, jw, jg, jb))


def test_wrappers_take_plain_path_on_cpu_and_raise_elsewhere():
    tx, tw, tg, tb = _inputs(200, 16, 24, seed=1)[:4]
    y, s, q = scb.fused_conv_bn_stats(tx, tw)
    for a, want in zip((y, s, q), scb.fused_conv_bn_stats_plain(tx, tw)):
        assert torch.equal(a, want)
    out = scb.bn_apply_relu(y, s, q, tg, tb)
    assert torch.equal(out, scb.bn_apply_relu_plain(y, s, q, tg, tb))
    assert scb.fused_conv_bn_stats.launches == scb.bn_apply_relu.launches == 0
    with pytest.raises(ValueError, match="no kernel for device meta"):
        scb.fused_conv_bn_stats(tx.to("meta"), tw.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        scb.bn_apply_relu(y.to("meta"), s, q, tg, tb)


def test_shapes_are_resnet50_bottleneck_convs():
    """The JAX spike's five (M, K, C), M floored to a multiple of 512."""
    assert scb.SHAPES == [(401408, 64, 64), (401408, 64, 256),
                          (100352, 512, 128), (25088, 1024, 256),
                          (6144, 2048, 512)]


def test_bounds_at_resnet50_shapes():
    """conv_bn_stats at (401408, 64, 64): 102.8 MB, 30.7 us (bytes); at
    (6144, 2048, 512): 12.9 GFLOP, 13.0 us (operations). bn_apply_relu at
    (401408, 256): 411 MB, 122.7 us."""
    ms, by, _, nbytes = scb.stats_bound(401408, 64, 64)
    assert (round(nbytes / 1e6, 1), round(ms * 1e3, 1), by) == \
        (102.8, 30.7, "bytes")
    ms, by, flops, _ = scb.stats_bound(6144, 2048, 512)
    assert (round(flops / 1e9, 1), round(ms * 1e3, 1), by) == \
        (12.9, 13.0, "operations")
    ms, by, _, nbytes = scb.apply_bound(401408, 256)
    assert (round(nbytes / 1e6), round(ms * 1e3, 1), by) == \
        (411, 122.7, "bytes")
    for m, k, c in scb.SHAPES:
        whole, parts = scb.block_bound(m, k, c), (scb.stats_bound(m, k, c),
                                                  scb.apply_bound(m, c))
        assert whole[3] == parts[0][3] + parts[1][3]
