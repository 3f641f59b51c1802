"""Op rules of the PyTorch port against the JAX package, op_test style:
each op of the GPT and BERT slices runs as a one-op program through both executors
on the CPU, with the same numpy inputs. Forward outputs agree to 1e-5
(f32), and so do the shapes and dtypes each package infers at build time
(the port on the meta device, JAX with jax.eval_shape). Gradients: the
same one-op program gets `gradients(out, inputs, target_gradients=[dOut])`
in each package; both emit the same grad-op descs, and the input grads
agree to 1e-5 (f32; the reference's op_test allows 5e-3). Random ops draw
other numbers in the two packages (torch.Generator vs JAX keys), so for
them the distributions are compared, and dropout's grad is checked with a
fed Mask. The ops the AMP rewrite puts on BERT's path (cast, einsum,
softmax) also run in bf16 (`test_op_in_dtype_matches_jax`). The ops the
gradient clips and the training telemetry tap append (elementwise_mul/
div/max, clip, clip_by_norm, squared_l2_norm, sqrt, isfinite,
logical_and, where, assign) run at the shapes those passes give them.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from torch_port_common import one_torch_thread  # noqa: F401


TOL = 1e-5
_R = np.random.RandomState(0)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


def _declare_inputs(blk, inputs):
    """Data vars for `inputs` ({slot: array, or list of arrays for a
    multi-var slot}); returns (slot -> var names, feed)."""
    in_map, feed = {}, {}
    for slot, arrs in inputs.items():
        names = []
        for i, arr in enumerate(arrs if isinstance(arrs, list) else [arrs]):
            n = f"{slot}_in{i}" if isinstance(arrs, list) else f"{slot}_in"
            blk.create_var(name=n, shape=arr.shape, dtype=str(arr.dtype))
            names.append(n)
            feed[n] = arr
        in_map[slot] = names
    return in_map, feed


def _run(pkg, exe, op_type, inputs, outputs, attrs):
    """One-op program in `pkg`; returns ({out: array}, {out: (shape,
    dtype)} as declared at build time)."""
    main = pkg.Program()
    blk = main.global_block
    in_map, feed = _declare_inputs(blk, inputs)
    out_map = {slot: [f"{slot}_out"] for slot in outputs}
    blk.append_op(op_type, in_map, out_map, attrs)
    names = [f"{s}_out" for s in outputs]
    vals = exe.run(main, feed=feed, fetch_list=names)
    decl = {n: (tuple(blk.var(n).shape), blk.var(n).dtype) for n in names}
    return dict(zip(names, (np.asarray(v) for v in vals))), decl


def _both(op_type, inputs, outputs, attrs):
    j = _run(pt, pt.Executor(), op_type, inputs, outputs, attrs)
    t = _run(ptt, ptt.Executor(ptt.CPUPlace()), op_type, inputs, outputs,
             attrs)
    return j, t


def _int32(dt):
    # JAX without x64 infers int64 results as int32; the port keeps int64
    return "int32" if dt == "int64" else dt


_ids = _R.randint(0, 10, (2, 5, 1)).astype(np.int64)
_labels = _R.randint(0, 7, (4, 3, 1)).astype(np.int64)
_labels[0, 0, 0] = -100     # one ignored position
_soft = np.abs(_f(4, 7))
_soft /= _soft.sum(-1, keepdims=True)
_pos = np.abs(_f(3, 4)) + 0.5
_inf = _f(3, 4)
_inf[1, 2] = np.inf
_mask = _R.rand(3, 4) > 0.5

# (case id, op type, inputs, output slots, attrs)
_CASES = [
    ("add_same", "elementwise_add", {"X": _f(2, 3, 4), "Y": _f(2, 3, 4)},
     ["Out"], {"axis": -1}),
    ("add_axis1", "elementwise_add", {"X": _f(2, 3, 4), "Y": _f(3)},
     ["Out"], {"axis": 1}),
    ("add_trailing", "elementwise_add", {"X": _f(2, 3, 4), "Y": _f(3, 4)},
     ["Out"], {"axis": -1}),
    ("mul_3d", "mul", {"X": _f(2, 3, 4), "Y": _f(4, 5)}, ["Out"],
     {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    ("mul_2d", "mul", {"X": _f(6, 4), "Y": _f(4, 5)}, ["Out"], {}),
    ("matmul_tY_alpha", "matmul", {"X": _f(2, 3, 4), "Y": _f(2, 5, 4)},
     ["Out"], {"transpose_X": False, "transpose_Y": True, "alpha": 0.5}),
    ("matmul_tX", "matmul", {"X": _f(4, 3), "Y": _f(4, 5)}, ["Out"],
     {"transpose_X": True, "transpose_Y": False, "alpha": 1.0}),
    ("reshape2_zero_dims", "reshape2", {"X": _f(2, 3, 4)},
     ["Out", "XShape"], {"shape": [0, -1, 2]}),
    ("reshape2_heads", "reshape2", {"X": _f(2, 6, 8)}, ["Out", "XShape"],
     {"shape": [0, 6, 2, 4]}),
    ("layer_norm", "layer_norm",
     {"X": _f(2, 3, 8), "Scale": _f(8), "Bias": _f(8)},
     ["Y", "Mean", "Variance"], {"begin_norm_axis": 2, "epsilon": 1e-5}),
    ("layer_norm_axis1", "layer_norm", {"X": _f(4, 6)},
     ["Y", "Mean", "Variance"], {"begin_norm_axis": 1, "epsilon": 1e-5}),
    ("fused_attention_ref", "fused_attention",
     {"Q": _f(1, 16, 2, 8), "K": _f(1, 16, 2, 8), "V": _f(1, 16, 2, 8)},
     ["Out"], {"causal": True, "sm_scale": 0.0, "cp_axis": "",
               "seq_parallel": "ring", "impl": "", "batch_axis": "dp"}),
    ("fused_attention_bias", "fused_attention",
     {"Q": _f(2, 16, 2, 8), "K": _f(2, 24, 2, 8), "V": _f(2, 24, 2, 8),
      "BiasK": _f(2, 24)},
     ["Out"], {"causal": False, "sm_scale": 0.3, "cp_axis": "",
               "seq_parallel": "ring", "impl": "xla", "batch_axis": "dp"}),
    ("gelu_tanh", "gelu", {"X": _f(3, 7)}, ["Out"], {"approximate": True}),
    ("gelu_erf", "gelu", {"X": _f(3, 7)}, ["Out"], {"approximate": False}),
    ("lookup_table", "lookup_table", {"W": _f(10, 6), "Ids": _ids},
     ["Out"], {"padding_idx": -1, "is_sparse": False}),
    ("lookup_table_pad", "lookup_table", {"W": _f(10, 6), "Ids": _ids},
     ["Out"], {"padding_idx": 3, "is_sparse": False}),
    ("assign_value", "assign_value", {}, ["Out"],
     {"shape": [2, 3], "dtype": "float32",
      "values": [0.5, 1.0, -2.0, 3.25, 4.0, 5.0]}),
    ("assign_value_int", "assign_value", {}, ["Out"],
     {"shape": [4], "dtype": "int64", "values": [0, 1, 2, 3]}),
    ("dropout_test_upscale", "dropout", {"X": _f(4, 5)}, ["Out", "Mask"],
     {"dropout_prob": 0.1, "is_test": True, "seed": 0,
      "dropout_implementation": "upscale_in_train"}),
    ("dropout_test_downgrade", "dropout", {"X": _f(4, 5)}, ["Out", "Mask"],
     {"dropout_prob": 0.3, "is_test": True, "seed": 0,
      "dropout_implementation": "downgrade_in_infer"}),
    ("fill_constant", "fill_constant", {}, ["Out"],
     {"shape": [3, 2], "dtype": "float32", "value": 1.5}),
    ("slice", "slice", {"Input": _f(3, 8, 4)}, ["Out"],
     {"axes": [1, 2], "starts": [1, -3], "ends": [7, 100]}),
    ("slice_decrease", "slice", {"Input": _f(3, 8, 4)}, ["Out"],
     {"axes": [0], "starts": [1], "ends": [2], "decrease_axis": [0]}),
    ("mean", "mean", {"X": _f(3, 4, 5)}, ["Out"], {}),
    ("einsum_scores", "einsum",
     {"Operands": [_f(2, 5, 3, 4), _f(2, 6, 3, 4)]}, ["Out"],
     {"equation": "bqnd,bknd->bnqk"}),
    ("softmax", "softmax", {"X": _f(2, 3, 7)}, ["Out"], {"axis": -1}),
    ("softmax_axis1", "softmax", {"X": _f(2, 3, 7)}, ["Out"], {"axis": 1}),
    ("softmax_xent", "softmax_with_cross_entropy",
     {"Logits": _f(4, 3, 7), "Label": _labels}, ["Softmax", "Loss"],
     {"soft_label": False, "ignore_index": -100, "axis": -1}),
    ("softmax_xent_soft", "softmax_with_cross_entropy",
     {"Logits": _f(4, 7), "Label": _soft}, ["Softmax", "Loss"],
     {"soft_label": True, "ignore_index": -100, "axis": -1}),
    ("sum", "sum", {"X": [_f(3, 4), _f(3, 4), _f(3, 4)]}, ["Out"], {}),
    ("scale", "scale", {"X": _f(3, 4)}, ["Out"],
     {"scale": 2.5, "bias": 0.5, "bias_after_scale": True}),
    ("scale_bias_first", "scale", {"X": _f(3, 4)}, ["Out"],
     {"scale": -1.5, "bias": 0.25, "bias_after_scale": False}),
    ("sgd", "sgd", {"Param": _f(4, 5), "Grad": _f(4, 5),
                    "LearningRate": np.array([0.1], np.float32)},
     ["ParamOut"], {}),
    ("mul_axis1", "elementwise_mul", {"X": _f(2, 3, 4), "Y": _f(3)},
     ["Out"], {"axis": 1}),
    ("mul_by_scale", "elementwise_mul", {"X": _f(4, 3), "Y": _f(1)},
     ["Out"], {"axis": -1}),
    ("div", "elementwise_div", {"X": _f(3, 4), "Y": _pos}, ["Out"],
     {"axis": -1}),
    ("max_trailing", "elementwise_max", {"X": _f(3, 4), "Y": _f(4)},
     ["Out"], {"axis": -1}),
    ("clip", "clip", {"X": _f(3, 4)}, ["Out"], {"min": -0.5, "max": 0.7}),
    ("clip_by_norm", "clip_by_norm", {"X": _f(3, 4)}, ["Out"],
     {"max_norm": 1.0}),
    ("clip_by_norm_under", "clip_by_norm", {"X": _f(3, 4)}, ["Out"],
     {"max_norm": 100.0}),
    ("squared_l2_norm", "squared_l2_norm", {"X": _f(3, 4)}, ["Out"], {}),
    ("sqrt", "sqrt", {"X": _pos}, ["Out"], {}),
    ("isfinite_true", "isfinite", {"X": _f(3, 4)}, ["Out"], {}),
    ("isfinite_inf", "isfinite", {"X": _inf}, ["Out"], {}),
    ("logical_and", "logical_and", {"X": _mask, "Y": _R.rand(3, 4) > 0.3},
     ["Out"], {}),
    ("where_flag", "where", {"Condition": np.array([False]),
                             "X": _f(4, 3), "Y": _f(4, 3)}, ["Out"], {}),
    ("where_mask", "where", {"Condition": _mask, "X": _f(3, 4),
                             "Y": _f(3, 4)}, ["Out"], {}),
    ("assign", "assign", {"X": _f(3, 4)}, ["Out"], {}),
    ("adam", "adam",
     {"Param": _f(4, 5), "Grad": _f(4, 5),
      "LearningRate": np.array([0.01], np.float32),
      "Moment1": _f(4, 5) * 0.1, "Moment2": np.abs(_f(4, 5)) * 0.01,
      "Beta1Pow": np.array([0.9 ** 3], np.float32),
      "Beta2Pow": np.array([0.999 ** 3], np.float32)},
     ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut"],
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
]


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_op_matches_jax(case):
    _, op_type, inputs, outputs, attrs = case
    (jvals, jdecl), (tvals, tdecl) = _both(op_type, inputs, outputs, attrs)
    for n in jvals:
        assert tdecl[n][0] == jdecl[n][0], n
        assert _int32(tdecl[n][1]) == _int32(jdecl[n][1]), n
        assert tvals[n].shape == jvals[n].shape, n
        np.testing.assert_allclose(tvals[n], jvals[n], atol=TOL, rtol=TOL,
                                   err_msg=n)


def _run_grad(pkg, exe, op_type, inputs, outputs, attrs, target, wrt):
    """One-op program plus `gradients([<target>_out], wrt inputs,
    target_gradients=[dOut])`; returns (grad arrays, the grad-op descs)."""
    main = pkg.Program()
    blk = main.global_block
    in_map, feed = _declare_inputs(blk, inputs)
    blk.append_op(op_type, in_map, {s: [f"{s}_out"] for s in outputs}, attrs)
    out = blk.var(f"{target}_out")
    feed["dout"] = np.random.RandomState(5).randn(*out.shape) \
        .astype(np.float32)
    blk.create_var(name="dout", shape=out.shape, dtype="float32")
    n_fwd = len(blk.ops)
    grads = pkg.gradients([out], [blk.var(n) for s in wrt
                                  for n in in_map[s]],
                          target_gradients=[blk.var("dout")])
    vals = exe.run(main, feed=feed, fetch_list=[g.name for g in grads])
    descs = [op.to_dict() for op in blk.ops[n_fwd:]]
    return [np.asarray(v) for v in vals], descs


# (case id, op type, inputs, output slots, attrs, target output, wrt slots)
_GRAD_CASES = [
    ("mul_3d", "mul", {"X": _f(2, 3, 4), "Y": _f(4, 5)}, ["Out"],
     {"x_num_col_dims": 2, "y_num_col_dims": 1}, "Out", ["X", "Y"]),
    ("mul_2d", "mul", {"X": _f(6, 4), "Y": _f(4, 5)}, ["Out"], {}, "Out",
     ["X", "Y"]),
    ("matmul_tY_alpha", "matmul", {"X": _f(2, 3, 4), "Y": _f(2, 5, 4)},
     ["Out"], {"transpose_X": False, "transpose_Y": True, "alpha": 0.5},
     "Out", ["X", "Y"]),
    ("matmul_tX", "matmul", {"X": _f(4, 3), "Y": _f(4, 5)}, ["Out"],
     {"transpose_X": True, "transpose_Y": False, "alpha": 1.0}, "Out",
     ["X", "Y"]),
    ("add_same", "elementwise_add", {"X": _f(2, 3, 4), "Y": _f(2, 3, 4)},
     ["Out"], {"axis": -1}, "Out", ["X", "Y"]),
    ("add_axis1", "elementwise_add", {"X": _f(2, 3, 4), "Y": _f(3)},
     ["Out"], {"axis": 1}, "Out", ["X", "Y"]),
    ("add_trailing", "elementwise_add", {"X": _f(2, 3, 4), "Y": _f(3, 4)},
     ["Out"], {"axis": -1}, "Out", ["X", "Y"]),
    ("layer_norm", "layer_norm",
     {"X": _f(2, 3, 8), "Scale": _f(8), "Bias": _f(8)},
     ["Y", "Mean", "Variance"], {"begin_norm_axis": 2, "epsilon": 1e-5},
     "Y", ["X", "Scale", "Bias"]),
    ("layer_norm_axis1", "layer_norm", {"X": _f(4, 6)},
     ["Y", "Mean", "Variance"], {"begin_norm_axis": 1, "epsilon": 1e-5},
     "Y", ["X"]),
    ("gelu_tanh", "gelu", {"X": _f(3, 7)}, ["Out"], {"approximate": True},
     "Out", ["X"]),
    ("gelu_erf", "gelu", {"X": _f(3, 7)}, ["Out"], {"approximate": False},
     "Out", ["X"]),
    ("reshape2", "reshape2", {"X": _f(2, 6, 8)}, ["Out", "XShape"],
     {"shape": [0, 6, 2, 4]}, "Out", ["X"]),
    ("slice", "slice", {"Input": _f(3, 8, 4)}, ["Out"],
     {"axes": [1, 2], "starts": [1, -3], "ends": [7, 100]}, "Out",
     ["Input"]),
    ("slice_decrease", "slice", {"Input": _f(3, 8, 4)}, ["Out"],
     {"axes": [0], "starts": [1], "ends": [2], "decrease_axis": [0]}, "Out",
     ["Input"]),
    ("lookup_table", "lookup_table", {"W": _f(10, 6), "Ids": _ids},
     ["Out"], {"padding_idx": -1, "is_sparse": False}, "Out", ["W"]),
    ("lookup_table_pad", "lookup_table", {"W": _f(10, 6), "Ids": _ids},
     ["Out"], {"padding_idx": 3, "is_sparse": False}, "Out", ["W"]),
    ("softmax_xent", "softmax_with_cross_entropy",
     {"Logits": _f(4, 3, 7), "Label": _labels}, ["Softmax", "Loss"],
     {"soft_label": False, "ignore_index": -100, "axis": -1}, "Loss",
     ["Logits"]),
    ("softmax_xent_soft", "softmax_with_cross_entropy",
     {"Logits": _f(4, 7), "Label": _soft}, ["Softmax", "Loss"],
     {"soft_label": True, "ignore_index": -100, "axis": -1}, "Loss",
     ["Logits"]),
    ("mean", "mean", {"X": _f(3, 4, 5)}, ["Out"], {}, "Out", ["X"]),
    ("einsum_ctx", "einsum", {"Operands": [_f(2, 3, 5, 6), _f(2, 6, 3, 4)]},
     ["Out"], {"equation": "bnqk,bknd->bqnd"}, "Out", ["Operands"]),
    ("softmax", "softmax", {"X": _f(2, 3, 7)}, ["Out"], {"axis": -1}, "Out",
     ["X"]),
    ("sum", "sum", {"X": [_f(3, 4), _f(3, 4)]}, ["Out"], {}, "Out", ["X"]),
    ("scale", "scale", {"X": _f(3, 4)}, ["Out"],
     {"scale": 2.5, "bias": 0.5, "bias_after_scale": True}, "Out", ["X"]),
    ("mul_axis1", "elementwise_mul", {"X": _f(2, 3, 4), "Y": _f(3)},
     ["Out"], {"axis": 1}, "Out", ["X", "Y"]),
    ("mul_by_scale", "elementwise_mul", {"X": _f(4, 3), "Y": _f(1)},
     ["Out"], {"axis": -1}, "Out", ["X", "Y"]),
    ("div", "elementwise_div", {"X": _f(3, 4), "Y": _pos}, ["Out"],
     {"axis": -1}, "Out", ["X", "Y"]),
    ("max_trailing", "elementwise_max", {"X": _f(3, 4), "Y": _f(4)},
     ["Out"], {"axis": -1}, "Out", ["X", "Y"]),
    ("clip", "clip", {"X": _f(3, 4)}, ["Out"], {"min": -0.5, "max": 0.7},
     "Out", ["X"]),
    ("clip_by_norm", "clip_by_norm", {"X": _f(3, 4)}, ["Out"],
     {"max_norm": 1.0}, "Out", ["X"]),
    ("squared_l2_norm", "squared_l2_norm", {"X": _f(3, 4)}, ["Out"], {},
     "Out", ["X"]),
    ("sqrt", "sqrt", {"X": _pos}, ["Out"], {}, "Out", ["X"]),
    ("where_mask", "where", {"Condition": _mask, "X": _f(3, 4),
                             "Y": _f(3, 4)}, ["Out"], {}, "Out", ["X", "Y"]),
    ("assign", "assign", {"X": _f(3, 4)}, ["Out"], {}, "Out", ["X"]),
    ("fused_attention_ref", "fused_attention",
     {"Q": _f(1, 16, 2, 8), "K": _f(1, 16, 2, 8), "V": _f(1, 16, 2, 8)},
     ["Out", "Lse"], {"causal": True, "sm_scale": 0.0, "cp_axis": "",
                      "seq_parallel": "ring", "impl": "",
                      "batch_axis": "dp"}, "Out", ["Q", "K", "V"]),
    ("fused_attention_bias", "fused_attention",
     {"Q": _f(2, 16, 2, 8), "K": _f(2, 24, 2, 8), "V": _f(2, 24, 2, 8),
      "BiasK": _f(2, 24)},
     ["Out", "Lse"], {"causal": False, "sm_scale": 0.3, "cp_axis": "",
                      "seq_parallel": "ring", "impl": "xla",
                      "batch_axis": "dp"}, "Out", ["Q", "K", "V"]),
    ("fused_attention_flash", "fused_attention",
     {"Q": _f(1, 256, 2, 16), "K": _f(1, 256, 2, 16),
      "V": _f(1, 256, 2, 16)},
     ["Out", "Lse"], {"causal": True, "sm_scale": 0.0, "cp_axis": "",
                      "seq_parallel": "ring", "impl": "flash",
                      "batch_axis": "dp"}, "Out", ["Q", "K", "V"]),
]


@pytest.mark.parametrize("case", _GRAD_CASES, ids=[c[0] for c in _GRAD_CASES])
def test_op_grad_matches_jax(case):
    """fused_attention_flash: JAX's interpret-mode backward kernel against
    the port's plain version of its kernel; the others the generic vjp or
    the op's own grad lowering on both sides."""
    _, op_type, inputs, outputs, attrs, target, wrt = case
    jg, jdesc = _run_grad(pt, pt.Executor(), op_type, inputs, outputs,
                          attrs, target, wrt)
    tg, tdesc = _run_grad(ptt, ptt.Executor(ptt.CPUPlace()), op_type,
                          inputs, outputs, attrs, target, wrt)
    assert tdesc == jdesc
    assert len(tg) == len(jg) > 0
    for t, j in zip(tg, jg):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, atol=TOL, rtol=TOL)


# bf16 values have 8 significant bits; a result computed in f32 and rounded
# once may land on the neighbouring bf16 value in the other package
BF16_ULP = 2.0 ** -7

# (case id, op type, inputs, attrs, wrt slots): cast, einsum and softmax
# as the AMP rewrite runs them
_DTYPE_CASES = [
    ("cast_to_bf16", "cast", {"X": _f(3, 4)}, {"out_dtype": "bfloat16"},
     ["X"]),
    ("cast_to_f32", "cast", {"X": _f(3, 4)}, {"out_dtype": "float32"},
     ["X"]),
    ("einsum_scores", "einsum",
     {"Operands": [_f(2, 5, 3, 4), _f(2, 6, 3, 4)]},
     {"equation": "bqnd,bknd->bnqk"}, ["Operands"]),
    ("einsum_ctx", "einsum", {"Operands": [_f(2, 3, 5, 6), _f(2, 6, 3, 4)]},
     {"equation": "bnqk,bknd->bqnd"}, ["Operands"]),
    ("softmax", "softmax", {"X": _f(2, 3, 7) * 3}, {"axis": -1}, ["X"]),
]


def _run_in_dtype(pkg, exe, op_type, inputs, attrs, wrt, dtype):
    """f32 data vars, each cast to `dtype` by a cast op (the AMP rewrite's
    pattern), then the op, then gradients back to the f32 inputs through
    the casts. Returns (fetched out, grads, declared out dtype, descs)."""
    main = pkg.Program()
    blk = main.global_block
    in_map, feed = _declare_inputs(blk, inputs)
    op_in = {}
    for slot, names in in_map.items():
        op_in[slot] = []
        for n in names:
            c = n + "@" + dtype
            blk.create_var(name=c, shape=blk.var(n).shape, dtype=dtype)
            blk.append_op("cast", {"X": [n]}, {"Out": [c]},
                          {"out_dtype": dtype})
            op_in[slot].append(c)
    blk.append_op(op_type, op_in, {"Out": ["Out_out"]}, attrs)
    out = blk.var("Out_out")
    feed["dout"] = np.random.RandomState(5).randn(*out.shape) \
        .astype(np.float32)
    blk.create_var(name="dout", shape=out.shape, dtype="float32")
    grads = pkg.gradients([out], [blk.var(n) for s in wrt
                                  for n in in_map[s]],
                          target_gradients=[blk.var("dout")])
    vals = exe.run(main, feed=feed,
                   fetch_list=["Out_out"] + [g.name for g in grads])
    vals = [np.asarray(v, dtype=np.float32) for v in vals]
    descs = [op.type for op in blk.ops]
    return vals[0], vals[1:], out.dtype, descs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _DTYPE_CASES,
                         ids=[c[0] for c in _DTYPE_CASES])
def test_op_in_dtype_matches_jax(case, dtype):
    """Forward and grad of cast, einsum and softmax on f32 or bf16
    operands: the same declared output dtype (softmax returns its input's
    dtype though it computes in f32), and values within 1e-5 in f32 or
    1e-5 + one bf16 ulp relative in bf16 (both packages accumulate bf16
    products in f32 and round once)."""
    _, op_type, inputs, attrs, wrt = case
    j = _run_in_dtype(pt, pt.Executor(), op_type, inputs, attrs, wrt, dtype)
    t = _run_in_dtype(ptt, ptt.Executor(ptt.CPUPlace()), op_type, inputs,
                      attrs, wrt, dtype)
    assert t[2] == j[2] and t[3] == j[3]
    want = attrs.get("out_dtype", dtype)
    assert t[2] == want
    rtol = TOL if dtype == "float32" and want == "float32" else BF16_ULP
    assert len(t[1]) == len(j[1]) > 0
    for a, b in zip([t[0]] + t[1], [j[0]] + j[1]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=TOL, rtol=rtol)


def _run_dropout_grad(pkg, exe, mask, dout, attrs):
    main = pkg.Program()
    blk = main.global_block
    blk.create_var(name="mask", shape=mask.shape, dtype="uint8")
    blk.create_var(name="dout", shape=dout.shape, dtype="float32")
    blk.create_var(name="dx", shape=dout.shape, dtype="float32")
    blk.append_op("dropout_grad", {"Mask": ["mask"], "Out@GRAD": ["dout"]},
                  {"X@GRAD": ["dx"]}, attrs, infer_shape=False)
    dx, = exe.run(main, feed={"mask": mask, "dout": dout}, fetch_list=["dx"])
    return np.asarray(dx)


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
@pytest.mark.parametrize("is_test", [False, True])
def test_dropout_grad_with_fed_mask_matches_jax(impl, is_test):
    """The grad replays the forward's Mask; fed the same Mask, the two
    packages give the same input grad."""
    mask = (_R.rand(6, 7) > 0.3).astype(np.uint8)
    dout = _f(6, 7)
    attrs = {"dropout_prob": 0.3, "is_test": is_test, "seed": 0,
             "dropout_implementation": impl}
    j = _run_dropout_grad(pt, pt.Executor(), mask, dout, attrs)
    t = _run_dropout_grad(ptt, ptt.Executor(ptt.CPUPlace()), mask, dout,
                          attrs)
    np.testing.assert_allclose(t, j, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("pad", [-1, 3])
def test_sparse_lookup_table_grad_matches_jax(pad):
    """is_sparse=True builds the JAX package's desc (a selected_rows grad
    var); the SelectedRows grad, fetched dense, equals JAX's (duplicate
    ids summed, the padding row left out)."""
    inputs = {"W": _f(10, 6), "Ids": _ids}
    attrs = {"padding_idx": pad, "is_sparse": True}
    jg, jdesc = _run_grad(pt, pt.Executor(), "lookup_table", inputs,
                          ["Out"], attrs, "Out", ["W"])
    tg, tdesc = _run_grad(ptt, ptt.Executor(ptt.CPUPlace()), "lookup_table",
                          inputs, ["Out"], attrs, "Out", ["W"])
    assert tdesc == jdesc
    np.testing.assert_allclose(tg[0], jg[0], atol=TOL, rtol=TOL)


def test_fused_attention_flash_op_matches_jax():
    """impl="flash" on the CPU: JAX's interpret-mode kernel vs the port's
    plain version of its kernel, Out and the kernel's row lse."""
    q, k, v = _f(1, 256, 2, 16), _f(1, 256, 2, 16), _f(1, 256, 2, 16)
    attrs = {"causal": True, "sm_scale": 0.0, "cp_axis": "",
             "seq_parallel": "ring", "impl": "flash", "batch_axis": "dp"}
    (jv, _), (tv, tdecl) = _both("fused_attention", {"Q": q, "K": k, "V": v},
                                 ["Out", "Lse"], attrs)
    np.testing.assert_allclose(tv["Out_out"], jv["Out_out"], atol=2e-5,
                               rtol=2e-5)
    # JAX's lse is lane-padded (bn, sq, 128); the port's is (bn, sq), and
    # its declared shape is the plain path's dummy (1, 1)
    assert tv["Lse_out"].shape == (2, 256)
    assert tdecl["Lse_out"][0] == (1, 1)
    np.testing.assert_allclose(tv["Lse_out"], jv["Lse_out"][:, :256, 0],
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("mean,std,seed", [(0.0, 0.02, 0), (1.0, 2.0, 7)])
def test_gaussian_random_distribution(mean, std, seed):
    attrs = {"shape": [300, 300], "dtype": "float32", "mean": mean,
             "std": std, "seed": seed}
    (jv, jdecl), (tv, tdecl) = _both("gaussian_random", {}, ["Out"], attrs)
    a, b = jv["Out_out"], tv["Out_out"]
    assert a.shape == b.shape == (300, 300)
    assert jdecl == tdecl
    for x in (a, b):
        assert abs(x.mean() - mean) < 0.02 * std
        assert abs(x.std() - std) < 0.02 * std


def test_uniform_random_distribution():
    """The Xavier initializer's op (embedding's default)."""
    attrs = {"shape": [300, 300], "dtype": "float32", "min": -0.5,
             "max": 1.5, "seed": 3}
    (jv, jdecl), (tv, tdecl) = _both("uniform_random", {}, ["Out"], attrs)
    assert jdecl == tdecl
    for x in (jv["Out_out"], tv["Out_out"]):
        assert x.shape == (300, 300)
        assert x.min() >= -0.5 and x.max() < 1.5
        assert abs(x.mean() - 0.5) < 0.01
        assert abs(x.std() - 2.0 / np.sqrt(12)) < 0.01


def test_dropout_train_distribution():
    x = np.ones((200, 200), np.float32)
    attrs = {"dropout_prob": 0.25, "is_test": False, "seed": 0,
             "dropout_implementation": "upscale_in_train"}
    exe = ptt.Executor(ptt.CPUPlace())
    vals, _ = _run(ptt, exe, "dropout", {"X": x}, ["Out", "Mask"], attrs)
    out, mask = vals["Out_out"], vals["Mask_out"]
    assert abs(mask.mean() - 0.75) < 0.01
    np.testing.assert_allclose(out, mask / 0.75, rtol=1e-6)


def test_cp_axis_is_not_ported_yet():
    q = _f(1, 8, 2, 4)
    attrs = {"causal": True, "sm_scale": 0.0, "cp_axis": "cp",
             "seq_parallel": "ring", "impl": "", "batch_axis": "dp"}
    with pytest.raises(Exception, match="not ported"):
        _run(ptt, ptt.Executor(ptt.CPUPlace()), "fused_attention",
             {"Q": q, "K": q, "V": q}, ["Out"], attrs)
