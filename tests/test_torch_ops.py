"""Op rules of the PyTorch port against the JAX package, op_test style:
each op of the GPT inference slice runs as a one-op program through both
executors on the CPU, with the same numpy inputs, forward only. Outputs
agree to 1e-5 (f32), and so do the shapes and dtypes each package infers
at build time (the port on the meta device, JAX with jax.eval_shape).
Random ops draw other numbers in the two packages (torch.Generator vs JAX
keys), so for them the distributions are compared.
"""

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt

TOL = 1e-5
_R = np.random.RandomState(0)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


def _run(pkg, exe, op_type, inputs, outputs, attrs):
    """One-op program in `pkg`; returns ({out: array}, {out: (shape,
    dtype)} as declared at build time)."""
    main = pkg.Program()
    blk = main.global_block
    in_map = {}
    for slot, arr in inputs.items():
        blk.create_var(name=f"{slot}_in", shape=arr.shape,
                       dtype=str(arr.dtype))
        in_map[slot] = [f"{slot}_in"]
    out_map = {slot: [f"{slot}_out"] for slot in outputs}
    blk.append_op(op_type, in_map, out_map, attrs)
    names = [f"{s}_out" for s in outputs]
    vals = exe.run(main, feed={f"{s}_in": a for s, a in inputs.items()},
                   fetch_list=names)
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
    ("softmax_xent", "softmax_with_cross_entropy",
     {"Logits": _f(4, 3, 7), "Label": _labels}, ["Softmax", "Loss"],
     {"soft_label": False, "ignore_index": -100, "axis": -1}),
    ("softmax_xent_soft", "softmax_with_cross_entropy",
     {"Logits": _f(4, 7), "Label": _soft}, ["Softmax", "Loss"],
     {"soft_label": True, "ignore_index": -100, "axis": -1}),
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
