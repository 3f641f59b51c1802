"""The head-slice repro of the PyTorch port
(`paddle_tpu_torch/tools/mosaic_repro_headslice.py`) against the JAX repro
(`tools/mosaic_repro_headslice.py`), on the CPU.

  * the JAX repro's `main` with its Pallas kernel in interpret mode prints
    OK, and its kernel's output, captured from `pallas_call`, matches the
    port's plain version on the same input within 2e-5 + 2e-5 relative (f32
    sums over d taken in other orders);
  * the wrapper runs the plain version on CPU tensors, whatever their
    strides, and raises on any device that is neither CPU nor CUDA;
  * the bound arithmetic at the repro's shape; `main` without a card exits
    non-zero. `chip_smoke.py` holds the kernel against the plain version on
    the card.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from jax.experimental import pallas as pl

from paddle_tpu_torch.tools import mosaic_repro_headslice as mrh

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
    """(4, 128, 12, 64): 8.4 MFLOP, 0.125 us at the fp32 peak, over 393 kB,
    0.117 us at 3.35 TB/s."""
    b, s, _, d = mrh.SHAPE
    ms, by, flops, nbytes = mrh.gram_bound(b, s, d)
    assert (round(flops / 1e6, 1), nbytes, by) == (8.4, 393216,
                                                    "operations")
    assert round(ms * 1e3, 3) == 0.125


def test_main_without_a_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["mosaic_repro_headslice"])
    with pytest.raises(SystemExit) as e:
        mrh.main()
    assert e.value.code != 0
