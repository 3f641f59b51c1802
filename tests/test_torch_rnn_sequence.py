"""The recurrent and sequence ops of the PyTorch port against the JAX
package, on the CPU.

  * the programs of tests/test_rnn_sequence.py (dynamic_lstm against a
    numpy recurrence, its frozen state past a length and its gradient;
    dynamic_gru against numpy; sequence_mask, the sequence_pool types,
    sequence_softmax and sequence_reverse over lengths) through both
    executors;
  * dynamic_lstm (with lengths, with peepholes, is_reverse), dynamic_gru,
    simple_rnn and gru_unit as one-op programs, op_test style: outputs
    within 1e-5, and the gradients of every float input within 5e-3
    (tests/op_test.py's tolerances), with the grad-op descs equal;
  * each of the 14 sequence ops after sequence_mask the same way
    (sequence_pool in all six types);
  * layers.lstm, 2 layers, bidirectional, over ragged lengths: the same
    program and one SGD step from the same weights.
"""

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_book import _sgd, build_both, check_step
from test_torch_control_flow import check_both
from test_torch_ops import _both, _int32, _run_grad
from torch_port_common import one_torch_thread  # noqa: F401


TOL = 1e-5
GRAD_TOL = 5e-3
_R = np.random.RandomState(17)


def _f(*shape, s=1.0):
    return (_R.randn(*shape) * s).astype(np.float32)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


# ---------------------------------------------------------------------------
# the programs of tests/test_rnn_sequence.py
# ---------------------------------------------------------------------------

_LSTM_X = _f(2, 5, 16, s=0.5)
_LSTM_W = _f(4, 16, s=0.5)
_LSTM_B = _f(1, 16, s=0.1)


def _param(pkg, name, arr):
    return pkg.ParamAttr(
        name=name, initializer=pkg.initializer.NumpyArrayInitializer(arr))


def _lstm_numpy(pkg):
    xv = pkg.layers.data("x", [5, 16])
    hidden, cell = pkg.layers.dynamic_lstm(
        xv, 16, param_attr=_param(pkg, "w", _LSTM_W),
        bias_attr=_param(pkg, "b", _LSTM_B))
    return [hidden, cell], 2


def _lstm_lengths(pkg):
    xv = pkg.layers.data("x", [6, 12])
    lv = pkg.layers.data("lens", [], dtype="int64")
    hidden, cell = pkg.layers.dynamic_lstm(xv, 12, sequence_length=lv)
    return [hidden, cell], 2


def _lstm_grad(pkg):
    xv = pkg.layers.data("x", [4, 12], stop_gradient=False)
    hidden, _ = pkg.layers.dynamic_lstm(xv, 12)
    return [hidden] + pkg.gradients([pkg.layers.mean(hidden)], [xv]), 1


_GRU_X = _f(2, 4, 9, s=0.5)
_GRU_W = _f(3, 9, s=0.5)


def _gru_numpy(pkg):
    xv = pkg.layers.data("x", [4, 9])
    return [pkg.layers.dynamic_gru(
        xv, 3, param_attr=_param(pkg, "w", _GRU_W), bias_attr=False)], 1


def _seq_mask(pkg):
    ln = pkg.layers.data("ln", [], dtype="int64")
    return [pkg.layers.sequence_mask(ln, maxlen=5)], 1


def _seq_pool_types(pkg):
    xv = pkg.layers.data("x", [3, 4])
    lv = pkg.layers.data("ln", [], dtype="int64")
    return [pkg.layers.sequence_pool(xv, t, lengths=lv)
            for t in ("sum", "average", "max", "last", "first")], 5


def _seq_softmax(pkg):
    xv = pkg.layers.data("x", [4])
    lv = pkg.layers.data("ln", [], dtype="int64")
    return [pkg.layers.sequence_softmax(xv, lengths=lv)], 1


def _seq_reverse(pkg):
    xv = pkg.layers.data("x", [4])
    lv = pkg.layers.data("ln", [], dtype="int64")
    return [pkg.layers.sequence_reverse(xv, lv)], 1


_PROGRAMS = [
    ("dynamic_lstm_numpy", _lstm_numpy, {"x": _LSTM_X}),
    ("dynamic_lstm_lengths_freeze", _lstm_lengths,
     {"x": _f(2, 6, 12), "lens": np.array([3, 6], np.int64)}),
    ("dynamic_lstm_grad", _lstm_grad, {"x": _f(2, 4, 12, s=0.3)}),
    ("dynamic_gru_numpy", _gru_numpy, {"x": _GRU_X}),
    ("sequence_mask", _seq_mask, {"ln": np.array([2, 5, 0], np.int64)}),
    ("sequence_pool_types", _seq_pool_types,
     {"x": np.arange(24, dtype="f").reshape(2, 3, 4),
      "ln": np.array([2, 3], np.int64)}),
    ("sequence_softmax_masks", _seq_softmax,
     {"x": _f(2, 4), "ln": np.array([2, 4], np.int64)}),
    ("sequence_reverse", _seq_reverse,
     {"x": np.arange(8, dtype="f").reshape(2, 4),
      "ln": np.array([3, 4], np.int64)}),
]


@pytest.mark.parametrize("build,feed", [p[1:] for p in _PROGRAMS],
                         ids=[p[0] for p in _PROGRAMS])
def test_rnn_sequence_program_matches_jax(build, feed):
    (j, t), = check_both(build, [feed])
    if build is _lstm_numpy:
        b, s, h = 2, 5, 4
        hh, cc = np.zeros((b, h), "f"), np.zeros((b, h), "f")
        ref = np.zeros((b, s, h))
        for k in range(s):
            i, f, g, o = np.split(_LSTM_X[:, k] + hh @ _LSTM_W
                                  + _LSTM_B[0], 4, axis=-1)
            cc = _sigmoid(f) * cc + _sigmoid(i) * np.tanh(g)
            hh = _sigmoid(o) * np.tanh(cc)
            ref[:, k] = hh
        np.testing.assert_allclose(t[0], ref, rtol=1e-4, atol=1e-5)
    elif build is _lstm_lengths:
        # beyond its length a row's state stays frozen, bit for bit
        np.testing.assert_array_equal(t[0][0, 3], t[0][0, 2])
        np.testing.assert_array_equal(t[0][0, 5], t[0][0, 2])
    elif build is _lstm_grad:
        assert t[1].shape == (2, 4, 12) and np.abs(t[1]).max() > 0
    elif build is _gru_numpy:
        hh = np.zeros((2, 3), "f")
        ref = np.zeros((2, 4, 3))
        for k in range(4):
            x_ur, x_c = _GRU_X[:, k, :6], _GRU_X[:, k, 6:]
            u, r = np.split(_sigmoid(x_ur + hh @ _GRU_W[:, :6]), 2, -1)
            hh = u * hh + (1 - u) * np.tanh(x_c + (r * hh) @ _GRU_W[:, 6:])
            ref[:, k] = hh
        np.testing.assert_allclose(t[0], ref, rtol=1e-4, atol=1e-5)
    elif build is _seq_mask:
        np.testing.assert_array_equal(
            t[0], [[1, 1, 0, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]])


# ---------------------------------------------------------------------------
# one-op programs, op_test style
# ---------------------------------------------------------------------------

_LENS = np.array([3, 5], np.int64)

# (id, op, inputs, output slots, attrs, target output, wrt slots)
_OP_CASES = [
    ("dynamic_lstm_lengths", "dynamic_lstm",
     {"Input": _f(2, 5, 16, s=0.5), "Weight": _f(4, 16, s=0.5),
      "Bias": _f(1, 16, s=0.1), "SequenceLength": _LENS},
     ["Hidden", "Cell", "LastH", "LastC"], {}, "Hidden",
     ["Input", "Weight", "Bias"]),
    ("dynamic_lstm_peepholes", "dynamic_lstm",
     {"Input": _f(2, 5, 16, s=0.5), "Weight": _f(4, 16, s=0.5),
      "Bias": _f(1, 28, s=0.3), "H0": _f(2, 4), "C0": _f(2, 4),
      "SequenceLength": _LENS},
     ["Hidden", "Cell", "LastH", "LastC"], {"use_peepholes": True}, "Cell",
     ["Input", "Weight", "Bias", "H0", "C0"]),
    ("dynamic_lstm_reverse", "dynamic_lstm",
     {"Input": _f(2, 5, 16, s=0.5), "Weight": _f(4, 16, s=0.5),
      "SequenceLength": _LENS},
     ["Hidden", "Cell", "LastH", "LastC"], {"is_reverse": True}, "Hidden",
     ["Input", "Weight"]),
    ("dynamic_gru", "dynamic_gru",
     {"Input": _f(2, 5, 12, s=0.5), "Weight": _f(4, 12, s=0.5),
      "Bias": _f(1, 12, s=0.1), "H0": _f(2, 4, s=0.5),
      "SequenceLength": _LENS},
     ["Hidden", "LastH"], {}, "Hidden", ["Input", "Weight", "Bias", "H0"]),
    ("simple_rnn", "simple_rnn",
     {"Input": _f(2, 5, 4), "Weight": _f(4, 4, s=0.5), "Bias": _f(1, 4),
      "SequenceLength": _LENS},
     ["Hidden", "LastH"], {}, "Hidden", ["Input", "Weight", "Bias"]),
    ("simple_rnn_relu", "simple_rnn",
     {"Input": _f(2, 5, 4), "Weight": _f(4, 4, s=0.5)},
     ["Hidden", "LastH"], {"activation": "relu"}, "Hidden",
     ["Input", "Weight"]),
    ("gru_unit", "gru_unit",
     {"Input": _f(3, 12), "HiddenPrev": _f(3, 4), "Weight": _f(4, 12),
      "Bias": _f(1, 12)},
     ["Hidden", "Gate", "ResetHiddenPrev"], {}, "Hidden",
     ["Input", "HiddenPrev", "Weight", "Bias"]),
]
_POOL_X = _f(2, 5, 3)
for _t in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"):
    _OP_CASES.append((f"sequence_pool_{_t.lower()}", "sequence_pool",
                      {"X": _POOL_X, "Length": _LENS}, ["Out"],
                      {"pooltype": _t}, "Out", ["X"]))
_OP_CASES += [
    ("sequence_softmax", "sequence_softmax",
     {"X": _f(2, 5), "Length": _LENS}, ["Out"], {}, "Out", ["X"]),
    ("sequence_reverse", "sequence_reverse",
     {"X": _f(2, 5, 3), "Length": _LENS}, ["Y"], {}, "Y", ["X"]),
    ("sequence_expand", "sequence_expand",
     {"X": _f(2, 3), "Y": _f(2, 4, 3)}, ["Out"], {"ref_level": 0}, "Out",
     ["X"]),
    ("sequence_expand_as", "sequence_expand_as",
     {"X": _f(2, 3), "Y": _f(2, 4, 5)}, ["Out"], {}, "Out", ["X"]),
    ("sequence_reshape", "sequence_reshape", {"X": _f(2, 4, 6)}, ["Out"],
     {"new_dim": 3}, "Out", ["X"]),
    ("sequence_scatter", "sequence_scatter",
     {"X": _f(2, 6), "Ids": np.array([[0, 2, 2], [5, 1, 0]], np.int64),
      "Updates": _f(2, 3)}, ["Out"], {}, "Out", ["X", "Updates"]),
    ("sequence_concat", "sequence_concat",
     {"X": [_f(2, 3, 4), _f(2, 2, 4)]}, ["Out"], {}, "Out", ["X"]),
    ("sequence_slice", "sequence_slice", {"X": _f(2, 6, 3)}, ["Out"],
     {"offset": 1, "length": 3}, "Out", ["X"]),
    ("sequence_pad", "sequence_pad", {"X": _f(2, 4, 3), "Length": _LENS},
     ["Out", "Length"], {}, "Out", ["X"]),
    ("sequence_unpad", "sequence_unpad",
     {"X": _f(2, 5, 3), "Length": _LENS}, ["Out"], {}, "Out", ["X"]),
    ("sequence_conv", "sequence_conv",
     {"X": _f(2, 5, 3), "Filter": _f(9, 4), "XLength": _LENS}, ["Out"],
     {"context_length": 3, "context_start": -1}, "Out", ["X", "Filter"]),
    ("sequence_conv_start0", "sequence_conv",
     {"X": _f(2, 5, 3), "Filter": _f(6, 4)}, ["Out"],
     {"context_length": 2, "context_start": 0}, "Out", ["X", "Filter"]),
    ("sequence_enumerate", "sequence_enumerate",
     {"X": _R.randint(0, 9, (2, 5)).astype(np.int64)}, ["Out"],
     {"win_size": 3, "pad_value": 0}, "Out", []),
    ("sequence_erase", "sequence_erase",
     {"X": _R.randint(0, 9, (2, 6)).astype(np.int64)}, ["Out"],
     {"tokens": [2, 5]}, "Out", []),
]


@pytest.mark.parametrize("case", _OP_CASES, ids=[c[0] for c in _OP_CASES])
def test_rnn_sequence_op_matches_jax(case):
    _, op_type, inputs, outputs, attrs, target, wrt = case
    (jvals, jdecl), (tvals, tdecl) = _both(op_type, inputs, outputs, attrs)
    for n in jvals:
        assert tdecl[n][0] == jdecl[n][0], n
        assert _int32(tdecl[n][1]) == _int32(jdecl[n][1]), n
        assert tvals[n].shape == jvals[n].shape, n
        np.testing.assert_allclose(tvals[n], jvals[n], atol=TOL, rtol=TOL,
                                   err_msg=n)
    if not wrt:
        return
    jg, jdesc = _run_grad(pt, pt.Executor(), op_type, inputs, outputs,
                          attrs, target, wrt)
    tg, tdesc = _run_grad(ptt, ptt.Executor(ptt.CPUPlace()), op_type,
                          inputs, outputs, attrs, target, wrt)
    assert tdesc == jdesc
    assert len(tg) == len(jg) > 0
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b, a, atol=GRAD_TOL, rtol=GRAD_TOL)


def test_lstm_bidirectional_two_layers_step_matches_jax():
    """layers.lstm(num_layers=2, is_bidirec=True) over ragged lengths,
    with its last states: one SGD step from the same weights."""
    def build(pkg):
        L = pkg.layers
        x = L.data("x", [6, 5])
        lens = L.data("lens", [], dtype="int64")
        out, last_h, last_c = L.lstm(x, hidden_size=4, num_layers=2,
                                     is_bidirec=True, sequence_length=lens)
        loss = L.mean(out) + L.mean(last_h) + L.mean(last_c)
        return {"loss": loss, "out": out}
    r = np.random.RandomState(9)
    feed = {"x": r.randn(3, 6, 5).astype(np.float32),
            "lens": np.array([6, 2, 4], np.int64)}
    j, t = check_step(*build_both(build, _sgd), feed, fetch=("loss", "out"))
    assert t[1].shape == (3, 6, 8)
