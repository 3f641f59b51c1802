"""The fused and quant op families (`ops/fused_ops.py`, `ops/quant_ops.py`)
of the PyTorch port against the JAX package's rules, on the CPU.

Each case calls the two packages' lowering rules directly on the same
seeded numpy inputs (`test_torch_core_ops.py`'s harness): all of JAX's
cases in one jitted function with `jax.vjp`, the port's rule on CPU
tensors, on meta tensors (build-time shape inference) and under
`torch.func.vjp`. Floats within op_test's 1e-5, ints exactly, every input
gradient of a differentiable rule within op_test's 5e-3 (max relative
error).

The quant ops' own gradient is the straight-through estimator
(`grad_lower`), not the vjp of their rounding forward: both packages'
grad rules run on the forward's outputs, and must agree exactly. The
inputs are fed on purpose where the port could part from JAX: values at
.5 of a quantization step (round half to even), zero scales (all-zero
tensors and channels, a zero moving state), values past the moving scale
(clipped, so the STE masks them) and the eval-mode moving scale. The
recurrences run with lengths, initial states, reversal, peepholes and two
bidirectional layers; the inception cell with both pool types and both
average rules.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework import registry as jreg
from paddle_tpu_torch.framework import registry as treg
from test_torch_core_ops import (_case, _check, _family, _jax_run,
                                 _torch_run)
from torch_port_common import one_torch_thread  # noqa: F401

_R = np.random.RandomState(23)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


def _pos(*shape):
    return (np.abs(_R.randn(*shape)) + 0.2).astype(np.float32)


def _i(hi, *shape):
    return _R.randint(0, hi, shape).astype(np.int64)


def _lens(*v):
    return np.array(v, np.int64)


# ---------------------------------------------------------------------------
# quant: .5 ties, zero scales, clipping
# ---------------------------------------------------------------------------

# max |x| = 127, so x * (127 / scale) is x itself: every k + .5 is a tie
_TIES = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5],
                  [-2.5, 3.5, 126.5, -126.5, 0.0, 7.25]], np.float32)
_CH = _f(4, 3, 3, 3)
_CH[1] = 0.0                             # a zero channel: scale 0
_CH[2, 0, 0, 0] = 1.0
_CH[2] = np.clip(_CH[2], -1, 1)
_CH[2, 0, 1] = [0.5 / 127, 1.5 / 127, -2.5 / 127]
_MOV = _f(3, 5) * 2.0
_MOV[0, 0] = 5.0                         # past the 3.0 state: clipped
_QNT = _f(2, 8)


def _quant_cases():
    return [
        _case("fqdq_abs_max_ties", "fake_quantize_dequantize_abs_max",
              {"X": _TIES}),
        _case("fqdq_abs_max", "fake_quantize_dequantize_abs_max",
              {"X": _f(3, 4, 5)}, {"bit_length": 4}),
        _case("fqdq_abs_max_zero", "fake_quantize_dequantize_abs_max",
              {"X": np.zeros((2, 3), np.float32)}),
        _case("fqdq_channel_conv",
              "fake_channel_wise_quantize_dequantize_abs_max",
              {"X": _CH}, {"quant_axis": 0}),
        _case("fqdq_channel_mul",
              "fake_channel_wise_quantize_dequantize_abs_max",
              {"X": _TIES.T.copy()}, {"quant_axis": 1, "bit_length": 8}),
        _case("fqdq_moving", "fake_quantize_dequantize_moving_average_abs_max",
              {"X": _MOV, "InScale": np.array([3.0], np.float32)},
              {"moving_rate": 0.9}),
        _case("fqdq_moving_first",
              "fake_quantize_dequantize_moving_average_abs_max",
              {"X": _MOV, "InScale": np.array([0.0], np.float32)}),
        _case("fqdq_moving_test",
              "fake_quantize_dequantize_moving_average_abs_max",
              {"X": _MOV, "InScale": np.array([2.0], np.float32)},
              {"is_test": True}),
        _case("fqdq_moving_test_zero",
              "fake_quantize_dequantize_moving_average_abs_max",
              {"X": _MOV, "InScale": np.array([0.0], np.float32)},
              {"is_test": True}),
        _case("quantize_abs_max_ties", "quantize_abs_max", {"X": _TIES}),
        _case("quantize_abs_max", "quantize_abs_max", {"X": _QNT},
              {"bit_length": 6}),
        _case("quantize_abs_max_zero", "quantize_abs_max",
              {"X": np.zeros((4,), np.float32)}),
        _case("dequantize_abs_max", "dequantize_abs_max",
              {"X": _i(255, 3, 4).astype(np.int8),
               "Scale": np.array([2.7], np.float32)}),
        _case("fake_dequantize_max_abs", "fake_dequantize_max_abs",
              {"X": np.round(_f(3, 4) * 40), "Scale": np.array(
                  [3.1], np.float32)}, {"max_range": 127.0}),
        _case("fake_channel_wise_dequantize_one",
              "fake_channel_wise_dequantize_max_abs",
              {"X": np.round(_f(4, 2, 3) * 40),
               "Scales": [_pos(4)]}, {"quant_bits": [8]}),
        _case("fake_channel_wise_dequantize_two",
              "fake_channel_wise_dequantize_max_abs",
              {"X": np.round(_f(4, 2, 3) * 40),
               "Scales": [_pos(4), np.array([5.0], np.float32)]},
              {"quant_bits": [8]}),
    ]


# ---------------------------------------------------------------------------
# fused: elementwise + activation, embeddings, recurrences, MLPs, pools,
# convs
# ---------------------------------------------------------------------------

def _cudnn_w(in_size, h, layers, ndir):
    n = 0
    for layer in range(layers):
        i = in_size if layer == 0 else h * ndir
        n += ndir * (i * 4 * h + h * 4 * h + 4 * h)
    return _f(n) * 0.3


def _fused_cases():
    x, y = _f(2, 3, 4), _f(2, 3, 4)
    seq = _f(3, 5, 4)
    pool_xs = [_pos(3, 4, 5), _pos(3, 4, 3)]
    pool_lens = [_lens(4, 2, 0), _lens(1, 4, 3)]
    return [
        _case("fea_add_relu", "fused_elemwise_activation",
              {"X": x, "Y": y},
              {"functor_list": ["relu", "elementwise_add"]}),
        _case("fea_mul_scale", "fused_elemwise_activation",
              {"X": x, "Y": y},
              {"functor_list": ["scale", "elementwise_mul"],
               "scale": 0.5}),
        _case("fea_add_tanh_bcast", "fused_elemwise_activation",
              {"X": x, "Y": _f(3)},
              {"functor_list": ["tanh", "elementwise_add"], "axis": 1}),
        _case("fea_sub_relu6", "fused_elemwise_activation",
              {"X": x * 5, "Y": y},
              {"functor_list": ["relu6", "elementwise_sub"]}),
        _case("fea_add_of_sigmoid", "fused_elemwise_activation",
              {"X": x, "Y": y},
              {"functor_list": ["elementwise_add", "sigmoid"]}),
        _case("fea_mul_of_scale_bcast", "fused_elemwise_activation",
              {"X": x, "Y": _f(4)},
              {"functor_list": ["elementwise_mul", "scale"], "scale": 3.0}),
        _case("fused_embedding_seq_pool", "fused_embedding_seq_pool",
              {"W": _f(10, 4), "Ids": _i(10, 3, 5, 1)}),
        _case("fused_embedding_seq_pool_len", "fused_embedding_seq_pool",
              {"W": _f(10, 4), "Ids": _i(10, 3, 5),
               "IdsLength": _lens(5, 2, 0)}),
        _case("fusion_gru", "fusion_gru",
              {"X": seq, "WeightX": _f(4, 9) * 0.5,
               "WeightH": _f(3, 9) * 0.5, "Bias": _f(1, 9) * 0.1,
               "H0": _f(3, 3), "SequenceLength": _lens(5, 3, 1)}),
        _case("fusion_gru_reverse", "fusion_gru",
              {"X": seq, "WeightX": _f(4, 9) * 0.5,
               "WeightH": _f(3, 9) * 0.5,
               "SequenceLength": _lens(2, 5, 4)},
              {"is_reverse": True, "activation": "relu"}),
        _case("fusion_lstm", "fusion_lstm",
              {"X": seq, "WeightX": _f(4, 12) * 0.5,
               "WeightH": _f(3, 12) * 0.5, "Bias": _f(1, 12) * 0.1,
               "H0": _f(3, 3), "C0": _f(3, 3),
               "SequenceLength": _lens(5, 3, 1)}),
        _case("fusion_lstm_peep_reverse", "fusion_lstm",
              {"X": seq, "WeightX": _f(4, 12) * 0.5,
               "WeightH": _f(3, 12) * 0.5, "Bias": _f(1, 21) * 0.1,
               "SequenceLength": _lens(4, 5, 2)},
              {"use_peepholes": True, "is_reverse": True}),
        _case("fused_embedding_fc_lstm", "fused_embedding_fc_lstm",
              {"Ids": _i(7, 3, 5, 1), "Embeddings": _f(7, 12) * 0.5,
               "WeightH": _f(3, 12) * 0.5, "Bias": _f(1, 12) * 0.1,
               "SequenceLength": _lens(5, 3, 1)}),
        _case("cudnn_lstm", "cudnn_lstm",
              {"Input": seq, "W": _cudnn_w(4, 3, 1, 1)},
              {"hidden_size": 3}),
        _case("cudnn_lstm_bidi_2", "cudnn_lstm",
              {"Input": seq, "W": _cudnn_w(4, 3, 2, 2),
               "InitH": _f(4, 3, 3), "InitC": _f(4, 3, 3),
               "SequenceLength": _lens(5, 2, 4)},
              {"hidden_size": 3, "num_layers": 2, "is_bidirec": True}),
        _case("fusion_repeated_fc_relu", "fusion_repeated_fc_relu",
              {"X": _f(3, 4), "W": [_f(4, 5), _f(5, 6), _f(6, 2)],
               "Bias": [_f(1, 5), _f(6), _f(1, 2)]}),
        _case("fusion_squared_mat_sub", "fusion_squared_mat_sub",
              {"X": _f(3, 4), "Y": _f(4, 5)}, {"scalar": 0.5}),
        _case("fusion_seqconv_eltadd_relu", "fusion_seqconv_eltadd_relu",
              {"X": seq, "Filter": _f(12, 6), "Bias": _f(6),
               "XLength": _lens(5, 3, 1)},
              {"contextLength": 3, "contextStart": -1}),
        _case("fusion_seqexpand_concat_fc", "fusion_seqexpand_concat_fc",
              {"X": [seq, _f(3, 2), _f(3, 1)], "FCWeight": _f(7, 5),
               "FCBias": _f(1, 5)}, {"fc_activation": "tanh"}),
        _case("fusion_seqexpand_concat_fc_plain",
              "fusion_seqexpand_concat_fc",
              {"X": [seq, _f(3, 3)], "FCWeight": _f(7, 2)}),
        _case("fusion_seqpool_concat_sum", "fusion_seqpool_concat",
              {"X": pool_xs, "XLength": pool_lens}),
        _case("fusion_seqpool_concat_avg", "fusion_seqpool_concat",
              {"X": pool_xs}, {"pooltype": "AVERAGE"}),
        _case("fusion_seqpool_concat_max", "fusion_seqpool_concat",
              {"X": pool_xs, "XLength": pool_lens}, {"pooltype": "MAX"}),
        _case("fusion_seqpool_cvm_concat", "fusion_seqpool_cvm_concat",
              {"X": pool_xs, "CVM": _pos(3, 2), "XLength": pool_lens}),
        _case("fusion_seqpool_cvm_concat_nocvm",
              "fusion_seqpool_cvm_concat",
              {"X": pool_xs, "CVM": _pos(3, 2)}, {"use_cvm": False}),
        _case("fusion_transpose_flatten_concat",
              "fusion_transpose_flatten_concat",
              {"X": [_f(2, 3, 4, 4), _f(2, 3, 2, 2), _f(2, 3, 1, 1)]},
              {"trans_axis": [0, 2, 3, 1], "flatten_axis": 1,
               "concat_axis": 1}),
        _case("fusion_transpose_flatten_concat_ax0",
              "fusion_transpose_flatten_concat",
              {"X": [_f(2, 3, 4), _f(2, 3, 2)]},
              {"trans_axis": [2, 0, 1], "flatten_axis": 2,
               "concat_axis": 0}),
        _case("conv2d_fusion", "conv2d_fusion",
              {"Input": _f(2, 3, 6, 6), "Filter": _f(4, 3, 3, 3),
               "Bias": _f(4), "ResidualData": _f(2, 4, 6, 6)},
              {"paddings": [1, 1]}),
        _case("conv2d_fusion_relu6_stride", "conv2d_fusion",
              {"Input": _f(2, 3, 7, 7) * 3, "Filter": _f(4, 3, 3, 3),
               "Bias": _f(4)},
              {"strides": [2, 2], "activation": "relu6"}),
        _case("conv2d_fusion_identity", "conv2d_fusion",
              {"Input": _f(1, 2, 5, 5), "Filter": _f(3, 2, 1, 1)},
              {"activation": "identity"}),
        _case("inception_max", "conv2d_inception_fusion",
              {"Input": _f(2, 4, 6, 6),
               "Filter": [_f(3, 4, 1, 1), _f(2 + 2 * 2, 4, 1, 1),
                          _f(6, 2, 3, 3), _f(2, 3, 3, 3)],
               "Bias": [_f(3), _f(6), _f(6), _f(2)]}),
        _case("inception_avg_exclusive", "conv2d_inception_fusion",
              {"Input": _f(2, 4, 5, 5),
               "Filter": [_f(2, 4, 1, 1), _f(3 + 2 * 1, 4, 1, 1),
                          _f(4, 1, 3, 3), _f(3, 2, 3, 3)],
               "Bias": [_f(2), _f(5), _f(4), _f(3)]},
              {"pooling_type": "avg"}),
        _case("inception_avg_inclusive", "conv2d_inception_fusion",
              {"Input": _f(1, 4, 5, 5),
               "Filter": [_f(2, 4, 1, 1), _f(3 + 2 * 1, 4, 1, 1),
                          _f(4, 1, 3, 3), _f(3, 2, 3, 3)],
               "Bias": [_f(2), _f(5), _f(4), _f(3)]},
              {"pooling_type": "avg", "exclusive": False,
               "activation": "sigmoid"}),
    ]


# one traced family for the file: one XLA compile
_CASES = _quant_cases() + _fused_cases()
_QUANT_TYPES = ("fake_quantize_dequantize_abs_max",
                "fake_channel_wise_quantize_dequantize_abs_max",
                "fake_quantize_dequantize_moving_average_abs_max",
                "quantize_abs_max", "dequantize_abs_max",
                "fake_dequantize_max_abs",
                "fake_channel_wise_dequantize_max_abs")


@_family(_CASES)
def test_fused_and_quant_ops_match_jax(k):
    _check(_CASES, k)


def test_cases_cover_both_rule_files():
    types = {c.values[0] for c in _CASES}
    fused = {n for n in jreg._REGISTRY
             if getattr(jreg._REGISTRY[n].lower, "__module__",
                        "").endswith(".fused_ops")}
    assert len(fused) == 15
    assert types == fused | set(_QUANT_TYPES)
    for n in types:
        assert n in treg._REGISTRY, n


_STE = [c for c in _CASES if c.values[0] in _QUANT_TYPES[:3]]


@pytest.mark.parametrize("k", range(len(_STE)), ids=[c.id for c in _STE])
def test_quant_ste_grads_match_jax(k):
    """The straight-through grad rules of both packages on the forward's
    outputs, with a random out-grad: equal. Where the 0-d scale clips the
    input, the gradient is masked (checked on the moving case)."""
    op, ins, attrs = _STE[k].values
    jout = _jax_run(op, ins, attrs)
    og = _R.randn(*np.asarray(ins["X"]).shape).astype(np.float32)
    scale = np.asarray(jout["OutScale"][0])
    gins = {"X": ins["X"], "Out@GRAD": og, "__out__OutScale": scale}
    jg = jreg._REGISTRY[op].grad_lower(
        None, {s: [jnp.asarray(v)] for s, v in gins.items()}, attrs)
    tg = treg._REGISTRY[op].grad_lower(
        None, {s: [torch.from_numpy(np.array(v))] for s, v in gins.items()},
        attrs)
    np.testing.assert_array_equal(tg["X@GRAD"][0].numpy(),
                                  np.asarray(jg["X@GRAD"][0]))
    if _STE[k].id == "fqdq_moving":
        # the clipped input gets no gradient
        assert tg["X@GRAD"][0][0, 0] == 0 and og[0, 0] != 0


def test_quant_codes_round_half_to_even():
    """The tie inputs land on even codes in the port, as in JAX."""
    out = _torch_run("quantize_abs_max", {"X": _TIES}, {})["Out"][0]
    assert out.dtype == torch.int8
    assert out.numpy().tolist() == [[127, 0, 2, 2, 0, -2],
                                    [-2, 4, 126, -126, 0, 7]]
