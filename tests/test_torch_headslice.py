"""The head-slice repro of the PyTorch port
(`paddle_tpu_torch/tools/mosaic_repro_headslice.py`) against the JAX repro
(`tools/mosaic_repro_headslice.py`), on the CPU.

  * the JAX repro's `main` with its Pallas kernel in interpret mode prints
    OK, and its kernel's output, captured from `pallas_call`, matches the
    port's plain version on the same input within 2e-5 + 2e-5 relative (f32
    sums over d taken in other orders);
  * the wrapper runs the plain version on CPU tensors, whatever their
    strides, and raises on any device that is neither CPU nor CUDA;
  * the JAX repro's reference einsum at GPT_SHAPE, GPT-2's attention
    tensors (2, 1024, 12, 64), matches the port's plain version (numpy
    inputs; no Pallas at that size);
  * the library's routing rule (`route`, the Python twin of
    csrc/headslice_gram.cu's) sends each of chip_smoke.py's Gram cases to
    the body the case names;
  * the bound arithmetic at both shapes; `main` without a card exits
    non-zero. `chip_smoke.py` holds the kernel against the plain version on
    the card. tests/test_torch_headslice_order.py emulates the
    tensor-core body's arithmetic and tile walk.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental import pallas as pl

from chip_smoke import GRAM_CASES, gram_input
from paddle_tpu_torch.tools import mosaic_repro_headslice as mrh
from torch_port_common import one_torch_thread  # noqa: F401


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_plain_version_matches_jax_kernel(monkeypatch, capsys):
    seen = []
    real = pl.pallas_call

    def capture(*args, **kw):
        kw["interpret"] = True
        call = real(*args, **kw)

        def run(x):
            out = call(x)
            seen.append((np.asarray(x), np.asarray(out)))
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", capture)
    spec = importlib.util.spec_from_file_location(
        "jax_mosaic_repro_headslice",
        os.path.join(_ROOT, "tools", "mosaic_repro_headslice.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    assert "OK" in capsys.readouterr().out
    (x, out), = seen
    assert x.shape == mrh.SHAPE and out.shape == (4, 128, 128)
    got = mrh.headslice_gram_plain(torch.from_numpy(x.copy()))
    np.testing.assert_allclose(got.numpy(), out, atol=mrh.TOL, rtol=mrh.TOL)


def test_wrapper_takes_plain_path_on_cpu_and_raises_elsewhere():
    x = torch.rand(2, 40, 3, 8, generator=torch.Generator().manual_seed(0))
    got = mrh.headslice_gram(x)
    want = torch.einsum("bqd,bkd->bqk", x[:, :, 2], x[:, :, 2])
    assert got.shape == (2, 40, 40)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    # a (b, s, n, d) view of another layout: only strides differ
    xt = x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    assert not xt.is_contiguous()
    assert torch.equal(mrh.headslice_gram(xt), got)
    assert mrh.headslice_gram.launches == 0
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mrh.headslice_gram(x.to("meta"))


def test_bound_at_repro_shape():
    """(4, 128, 12, 64): 8.4 MFLOP over 393 kB; bound by bytes at 0.117 us
    (3.35 TB/s), beside the fp32 FMA bound 0.125 us and the split TF32
    bound 0.051 us."""
    b, s, _, d = mrh.SHAPE
    ms, by, flops, nbytes, bounds = mrh.gram_bound(b, s, d)
    assert (round(flops / 1e6, 1), nbytes, by) == (8.4, 393216, "bytes")
    assert round(ms * 1e3, 3) == 0.117
    assert ms == bounds["bytes_ms"] == max(bounds["bytes_ms"],
                                           bounds["tf32x3_ms"])
    assert (round(bounds["fp32_ms"] * 1e3, 3),
            round(bounds["tf32x3_ms"] * 1e3, 3)) == (0.125, 0.051)


def test_bound_at_gpt_shape():
    """(2, 1024, 12, 64): 268 MFLOP over 0.52 MB read and 8.39 MB written;
    bound by bytes at 2.66 us, beside fp32 FMA 4.01 us and split TF32
    1.63 us."""
    b, s, _, d = mrh.GPT_SHAPE
    ms, by, flops, nbytes, bounds = mrh.gram_bound(b, s, d)
    assert (round(flops / 1e6), nbytes, by) == (268, 8912896, "bytes")
    assert (round(ms * 1e3, 2), round(bounds["fp32_ms"] * 1e3, 2),
            round(bounds["tf32x3_ms"] * 1e3, 2)) == (2.66, 4.01, 1.63)


def test_plain_version_matches_jnp_einsum_at_gpt_shape():
    # the JAX repro's reference line, typed again in jnp: the repro's main()
    # fixes its own shape, so neither its kernel nor its einsum runs here
    x = np.random.RandomState(0).rand(*mrh.GPT_SHAPE).astype(np.float32)
    ref = jnp.einsum("bqnd,bknd->bqk", x[:, :, -1:, :], x[:, :, -1:, :])
    got = mrh.headslice_gram_plain(torch.from_numpy(x))
    assert got.shape == (2, 1024, 1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=mrh.TOL,
                               rtol=mrh.TOL)


@pytest.mark.parametrize("shape,layout,body", GRAM_CASES)
def test_routing_sends_each_chip_case_to_its_body(shape, layout, body):
    x = gram_input(shape, layout, torch.Generator().manual_seed(0), "cpu")
    assert mrh.route(*shape, x.stride(), 0) == body


def test_chip_cases_hold_both_shapes_and_both_bodies():
    shapes = {(shape, layout) for shape, layout, _ in GRAM_CASES}
    assert {(mrh.SHAPE, "bsnd"), (mrh.GPT_SHAPE, "bsnd"),
            (mrh.GPT_SHAPE, "bnsd")} <= shapes
    assert {body for *_, body in GRAM_CASES} == {"tc", "simt"}


@pytest.mark.parametrize("why,strides,misalign,s,d", [
    ("x misaligned", (64 * 12 * 128, 64 * 12, 64, 1), 4, 128, 64),
    ("inner stride 2", (2 * 64 * 12 * 128, 2 * 64 * 12, 128, 2), 0, 128, 64),
    ("a zero stride", (0, 64 * 12, 64, 1), 0, 128, 64),
    ("s % 4", (64 * 12 * 130, 64 * 12, 64, 1), 0, 130, 64),
    ("d > 224", (228 * 12 * 128, 228 * 12, 228, 1), 0, 128, 228),
])
def test_routing_sends_what_tma_cannot_address_to_simt(why, strides,
                                                       misalign, s, d):
    assert mrh.route(4, s, 12, d, strides, misalign) == "simt", why
    assert mrh.route(4, 128, 12, 64, (64 * 12 * 128, 64 * 12, 64, 1),
                     0) == "tc"


def test_main_without_a_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["mosaic_repro_headslice"])
    with pytest.raises(SystemExit) as e:
        mrh.main()
    assert e.value.code != 0
