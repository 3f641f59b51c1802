"""The core op library's rest (activation, math, tensor and nn op families
and the misc/extra ops the layer files append) of the PyTorch port
against the JAX package's rules, on the CPU.

Each case calls the two packages' lowering rules directly on the same
seeded numpy inputs: JAX's eagerly, the port's on CPU tensors and once
more on meta tensors (the build-time shape inference, which must give the
CPU run's shapes and dtypes). Outputs agree within op_test's 1e-5 (rtol
and atol). Where the op is differentiable, `jax.vjp` and `torch.func.vjp`
of the two rules take the same random cotangents, and every input
gradient agrees within op_test's max relative error 5e-3 (max |a - b|
over max(max |a|, max |b|, 1e-3)). JAX without x64 gives int32 where the
port declares int64 (ROADMAP §C, "Declared int dtypes").

The random ops draw other numbers in the two packages (a torch.Generator
against JAX keys, ROADMAP §C): they are held on shapes, dtypes, ranges,
moments at n = 1e5, and equal draws for equal seeds.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the JAX rules)
import paddle_tpu_torch  # noqa: F401  (registers the port's rules)
from paddle_tpu.framework import registry as jreg
from paddle_tpu.framework.selected_rows import SelectedRows as JSR
from paddle_tpu_torch.framework import registry as treg
from torch_port_common import one_torch_thread  # noqa: F401

OUT_TOL = 1e-5
GRAD_TOL = 5e-3
_R = np.random.RandomState(20)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


def _pos(*shape):
    return (np.abs(_R.randn(*shape)) + 0.2).astype(np.float32)


def _u(lo, hi, *shape):
    return _R.uniform(lo, hi, shape).astype(np.float32)


def _i(hi, *shape):
    return _R.randint(0, hi, shape).astype(np.int64)


def _slots(ins):
    return {s: (v if isinstance(v, list) else [v]) for s, v in ins.items()}


def _jax_run(op, ins, attrs, key=0):
    ctx = jreg.LowerContext(rng_key=jax.random.PRNGKey(key))
    return jreg._REGISTRY[op].lower(
        ctx, {s: [jnp.asarray(a) for a in v] for s, v in _slots(ins).items()},
        attrs)


def _torch_run(op, ins, attrs, device="cpu", seed=0):
    ctx = treg.LowerContext(device=device, seed=seed,
                            abstract=device == "meta")
    tins = {s: [torch.from_numpy(np.array(a)).to(device) for a in v]
            for s, v in _slots(ins).items()}
    return treg._REGISTRY[op].lower(ctx, tins, attrs)


def _dtype_ok(t, j):
    if str(t.dtype) == str(j.dtype):
        return True
    return str(t.dtype) == "int64" and str(j.dtype) == "int32"


def _grad_spec(op, ins, attrs):
    """(input slots that take a gradient, outputs it flows from with their
    shapes): floating inputs outside no_grad_inputs, floating outputs
    outside non_diff_outputs, as the registries' generic vjp picks them."""
    jd = jreg._REGISTRY[op]
    if jd.not_differentiable:
        return [], []
    slots = _slots(ins)
    wrt = [(s, i) for s, v in slots.items() if s not in jd.no_grad_inputs
           for i, a in enumerate(v)
           if np.issubdtype(np.asarray(a).dtype, np.floating)]
    shapes = jax.eval_shape(
        lambda a: jd.lower(jreg.LowerContext(rng_key=jax.random.PRNGKey(0)),
                           a, attrs),
        {s: [jnp.asarray(a) for a in v] for s, v in slots.items()})
    outs = [(s, i, tuple(o.shape)) for s in sorted(shapes)
            if s not in jd.non_diff_outputs
            for i, o in enumerate(shapes[s])
            if jnp.issubdtype(o.dtype, jnp.floating)]
    return (wrt, outs) if wrt and outs else ([], [])


def _cotangents(outs):
    rng = np.random.RandomState(7)
    return [np.asarray(rng.randn(*shape), np.float32) for _, _, shape in outs]


_JAX_FAMILIES = {}
# small shapes: the compile, not the run, is the cost
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def _jax_family(cases):
    """JAX's outputs and input gradients (jax.vjp) for every case of a
    family, from one jitted function: one XLA compile a family instead of
    one per primitive and shape in eager mode."""
    key = id(cases)
    if key in _JAX_FAMILIES:
        return _JAX_FAMILIES[key]
    specs = [_grad_spec(*c.values) for c in cases]

    def run(all_ins, all_cots):
        res = []
        for c, ins, cots, (wrt, outs) in zip(cases, all_ins, all_cots,
                                              specs):
            op, _, attrs = c.values
            jd = jreg._REGISTRY[op]

            def lower(a, _jd=jd, _attrs=attrs):
                return _jd.lower(jreg.LowerContext(
                    rng_key=jax.random.PRNGKey(0)), a, _attrs)

            if not wrt:
                res.append((lower(ins), ()))
                continue

            # the vjp's aux output is the whole forward: one trace a rule
            def f(*flat, _ins=ins, _wrt=wrt, _outs=outs, _lower=lower):
                b = {s: list(v) for s, v in _ins.items()}
                for (s, i), a in zip(_wrt, flat):
                    b[s][i] = a
                r = _lower(b)
                return tuple(r[s][i] for s, i, _ in _outs), r
            _, vjp, fwd = jax.vjp(f, *[ins[s][i] for s, i in wrt],
                                  has_aux=True)
            res.append((fwd, vjp(tuple(cots))))
        return res

    all_ins = [{s: [jnp.asarray(a) for a in v]
                for s, v in _slots(c.values[1]).items()} for c in cases]
    all_cots = [[jnp.asarray(a) for a in _cotangents(outs)]
                for _, outs in specs]
    out = jax.jit(run, compiler_options=_FAST_COMPILE)(all_ins, all_cots)
    _JAX_FAMILIES[key] = [(spec, fwd, grads) for spec, (fwd, grads)
                          in zip(specs, out)]
    return _JAX_FAMILIES[key]


def _check(cases, k):
    """Case k of a family: the port's rule on the CPU (and on the meta
    device) against JAX's outputs, and torch.func.vjp against jax.vjp."""
    op, ins, attrs = cases[k].values
    (wrt, outs), jout, jgrads = _jax_family(cases)[k]
    tout = _torch_run(op, ins, attrs)
    meta = _torch_run(op, ins, attrs, device="meta")
    assert set(tout) == set(jout), (sorted(tout), sorted(jout))
    for slot in jout:
        assert len(tout[slot]) == len(jout[slot])
        for t, m, j in zip(tout[slot], meta[slot], jout[slot]):
            j = np.asarray(j)
            tn = t.numpy()
            assert tn.shape == j.shape, (slot, tn.shape, j.shape)
            assert _dtype_ok(tn, j), (slot, tn.dtype, j.dtype)
            assert tuple(m.shape) == tn.shape and m.dtype == t.dtype
            if np.issubdtype(j.dtype, np.floating):
                np.testing.assert_allclose(tn, j, rtol=OUT_TOL, atol=OUT_TOL,
                                           err_msg=f"{op} {slot}")
            else:
                np.testing.assert_array_equal(tn, j, err_msg=f"{op} {slot}")
    if not wrt:
        return
    slots = _slots(ins)
    td = treg._REGISTRY[op]

    def tf(*flat):
        b = {s: [torch.from_numpy(np.array(a)) for a in v]
             for s, v in slots.items()}
        for (s, i), a in zip(wrt, flat):
            b[s][i] = a
        r = td.lower(treg.LowerContext(), b, attrs)
        return tuple(r[s][i] for s, i, _ in outs)

    _, tvjp = torch.func.vjp(tf, *[torch.from_numpy(np.array(slots[s][i]))
                                   for s, i in wrt])
    tgrads = tvjp(tuple(torch.from_numpy(c) for c in _cotangents(outs)))
    for (s, i), a, b in zip(wrt, tgrads, jgrads):
        rel = _op_test_rel(a.numpy(), np.asarray(b))
        assert rel <= GRAD_TOL, f"{op} grad of {s}[{i}]: {rel}"


def _op_test_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    denom = max(np.abs(a).max(initial=0), np.abs(b).max(initial=0), 1e-3)
    return np.abs(a - b).max(initial=0) / denom


def _case(cid, op, ins, attrs=None):
    return pytest.param(op, ins, attrs or {}, id=cid)


def _family(cases):
    """Parametrize a test over the case indices of a family."""
    return pytest.mark.parametrize("k", range(len(cases)),
                                   ids=[c.id for c in cases])


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

_X = _f(3, 4, 5)
_ACT_CASES = [_case(n, n, {"X": _X}) for n in (
    "relu6", "logsigmoid", "tanh_shrink", "leaky_relu", "elu", "selu",
    "softplus", "softsign", "swish", "silu", "hard_sigmoid", "hard_swish",
    "mish", "abs", "sin", "tan", "atan", "sinh", "cosh", "erf",
    "softshrink", "hard_shrink", "thresholded_relu", "brelu", "stanh",
    "sign")]
_ACT_CASES += [
    _case("log", "log", {"X": _pos(3, 4)}),
    _case("log2", "log2", {"X": _pos(3, 4)}),
    _case("log10", "log10", {"X": _pos(3, 4)}),
    _case("log1p", "log1p", {"X": _u(-0.5, 2.0, 3, 4)}),
    _case("rsqrt", "rsqrt", {"X": _pos(3, 4)}),
    _case("reciprocal", "reciprocal", {"X": _pos(3, 4) * np.sign(_f(3, 4))}),
    _case("asin", "asin", {"X": _u(-0.9, 0.9, 3, 4)}),
    _case("acos", "acos", {"X": _u(-0.9, 0.9, 3, 4)}),
    _case("relu6_attr", "relu6", {"X": _X * 4}, {"threshold": 3.0}),
    _case("leaky_relu_attr", "leaky_relu", {"X": _X}, {"alpha": 0.2}),
    _case("elu_attr", "elu", {"X": _X}, {"alpha": 0.5}),
    _case("swish_beta", "swish", {"X": _X}, {"beta": 2.0}),
    _case("hard_sigmoid_attr", "hard_sigmoid", {"X": _X * 3},
          {"slope": 0.3, "offset": 0.4}),
    _case("hard_swish_attr", "hard_swish", {"X": _X * 3},
          {"offset": 2.0, "threshold": 5.0, "scale": 5.0}),
    _case("stanh_attr", "stanh", {"X": _X}, {"scale_a": 0.5,
                                             "scale_b": 2.0}),
    _case("softshrink_attr", "softshrink", {"X": _X}, {"lambda": 0.3}),
    _case("hard_shrink_attr", "hard_shrink", {"X": _X}, {"threshold": 0.8}),
    _case("thresholded_relu_attr", "thresholded_relu", {"X": _X},
          {"threshold": 0.4}),
    _case("brelu_attr", "brelu", {"X": _X * 5}, {"t_min": -1.0,
                                                 "t_max": 2.0}),
    _case("selu_attr", "selu", {"X": _X}, {"scale": 1.5, "alpha": 2.0}),
    _case("log_softmax", "log_softmax", {"X": _X}),
    _case("log_softmax_axis1", "log_softmax", {"X": _X}, {"axis": 1}),
    _case("maxout", "maxout", {"X": _f(2, 6, 3, 4)}, {"groups": 3}),
]


@_family(_ACT_CASES)
def test_activation_ops_match_jax(k):
    _check(_ACT_CASES, k)


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------

_MATH_CASES = [
    _case("floordiv", "elementwise_floordiv",
          {"X": _f(3, 4) * 4, "Y": _pos(3, 4)}),
    _case("floordiv_int", "elementwise_floordiv",
          {"X": _i(20, 3, 4) - 10, "Y": _i(4, 4) + 1}),
    _case("bmm", "bmm", {"X": _f(2, 3, 4), "Y": _f(2, 4, 5)}),
    _case("dot", "dot", {"X": _f(3, 4), "Y": _f(3, 4)}),
    _case("p_norm", "p_norm", {"X": _f(3, 4, 5)}),
    _case("p_norm_3_keep", "p_norm", {"X": _f(3, 4, 5)},
          {"porder": 3.0, "axis": 1, "keepdim": True}),
    _case("l2_normalize", "l2_normalize", {"X": _f(3, 4, 5)}, {"axis": 1}),
    _case("log_sum_exp", "log_sum_exp", {"X": _f(3, 4, 5)}),
    _case("log_sum_exp_keep", "log_sum_exp", {"X": _f(3, 4, 5)},
          {"dim": [0, 2], "keep_dim": True}),
]


@_family(_MATH_CASES)
def test_math_ops_match_jax(k):
    _check(_MATH_CASES, k)


# ---------------------------------------------------------------------------
# tensor: shape and layout, indexing, queries and ordering
# ---------------------------------------------------------------------------

_TIES = np.array([[3, 1, 2, 1, 3, 0], [2, 2, 2, 5, 1, 1]], np.float32)
_COND = _R.rand(4, 5) > 0.6
_COND[0] = False

_TENSOR_CASES = [
    _case("reshape", "reshape", {"X": _f(2, 3, 4)}, {"shape": [0, -1]}),
    _case("transpose", "transpose", {"X": _f(2, 3, 4)}, {"axis": [2, 0, 1]}),
    _case("flatten2", "flatten2", {"X": _f(2, 3, 4, 2)}, {"axis": 2}),
    _case("flatten_range", "flatten_contiguous_range", {"X": _f(2, 3, 4, 2)},
          {"start_axis": 1, "stop_axis": 2}),
    _case("stack", "stack", {"X": [_f(3, 4), _f(3, 4), _f(3, 4)]},
          {"axis": 1}),
    _case("unstack", "unstack", {"X": _f(3, 4, 2)}, {"axis": 1}),
    _case("strided_slice", "strided_slice", {"Input": _f(5, 7, 3)},
          {"axes": [0, 1], "starts": [0, 6], "ends": [5, 0],
           "strides": [2, -2]}),
    _case("strided_slice_neg", "strided_slice", {"Input": _f(6, 4)},
          {"axes": [0], "starts": [-1], "ends": [-7], "strides": [-3]}),
    _case("pad", "pad", {"X": _f(2, 3, 4)},
          {"paddings": [0, 1, 2, 0, 1, 3], "pad_value": 0.5}),
    _case("pad2d_constant", "pad2d", {"X": _f(2, 3, 4, 5)},
          {"paddings": [1, 2, 0, 3], "pad_value": -1.0}),
    _case("pad2d_reflect", "pad2d", {"X": _f(2, 3, 4, 5)},
          {"paddings": [3, 2, 4, 1], "mode": "reflect"}),
    _case("pad2d_edge", "pad2d", {"X": _f(2, 3, 4, 5)},
          {"paddings": [2, 1, 0, 3], "mode": "edge"}),
    _case("expand", "expand", {"X": _f(2, 1, 3)},
          {"expand_times": [2, 3, 1]}),
    _case("expand_as", "expand_as",
          {"X": _f(2, 3), "target_tensor": _f(4, 6)}),
    _case("tile_short", "tile", {"X": _f(2, 3, 4)}, {"repeat_times": [2, 1]}),
    _case("roll", "roll", {"X": _f(3, 4, 5)},
          {"shifts": [1, -2], "axis": [0, 2]}),
    _case("roll_one_shift", "roll", {"X": _f(3, 4, 5)},
          {"shifts": 2, "axis": [1, 2]}),
    _case("flip", "flip", {"X": _f(3, 4, 5)}, {"axis": [0, 2]}),
    _case("gather", "gather", {"X": _f(6, 4), "Index": np.array(
        [5, 0, 2, 0, 5], np.int64)}),
    _case("gather_nd", "gather_nd", {"X": _f(4, 5, 3), "Index": np.array(
        [[0, 1], [3, 4], [0, 1]], np.int64)}),
    _case("scatter_overwrite", "scatter",
          {"X": _f(6, 3), "Ids": np.array([4, 0, 2], np.int64),
           "Updates": _f(3, 3)}, {"overwrite": True}),
    _case("scatter_add_repeated", "scatter",
          {"X": _f(6, 3), "Ids": np.array([4, 0, 4, 4, 1], np.int64),
           "Updates": _f(5, 3)}, {"overwrite": False}),
    _case("scatter_nd_add", "scatter_nd_add",
          {"X": _f(4, 5, 2), "Index": np.array(
              [[1, 2], [3, 0], [1, 2], [1, 2]], np.int64),
           "Updates": _f(4, 2)}),
    _case("index_select", "index_select",
          {"X": _f(3, 5, 2), "Index": np.array([4, 1, 4], np.int64)},
          {"dim": 1}),
    _case("where_index", "where_index", {"Condition": _COND}),
    _case("where_index_none", "where_index",
          {"Condition": np.zeros((2, 3), bool)}),
    _case("shape", "shape", {"Input": _f(2, 3, 4)}),
    _case("size", "size", {"Input": _f(2, 3, 4)}),
    _case("fill_zeros_like", "fill_zeros_like", {"X": _f(2, 3)}),
    _case("arg_min", "arg_min", {"X": _TIES}, {"axis": 1}),
    _case("argsort_ties", "argsort", {"X": _TIES}),
    _case("argsort_ties_desc", "argsort", {"X": _TIES},
          {"descending": True}),
    _case("argsort_axis0_desc", "argsort", {"X": _f(5, 3)},
          {"axis": 0, "descending": True}),
    _case("cumprod", "cumprod", {"X": _u(0.5, 1.5, 3, 4)}, {"dim": 1}),
    _case("optimization_barrier", "optimization_barrier",
          {"X": [_f(2, 3), _f(4)]}),
    _case("lookup_table_v2", "lookup_table_v2",
          {"W": _f(10, 4), "Ids": _i(10, 3, 5)}, {"padding_idx": -1}),
    _case("lookup_table_v2_pad", "lookup_table_v2",
          {"W": _f(10, 4), "Ids": np.array([[1, 3, 3], [0, 9, 3]],
                                           np.int64)},
          {"padding_idx": 3}),
]


@_family(_TENSOR_CASES)
def test_tensor_ops_match_jax(k):
    _check(_TENSOR_CASES, k)


def test_where_index_pads_with_minus_one():
    out = _torch_run("where_index", {"Condition": _COND}, {})["Out"][0]
    flat = np.flatnonzero(_COND.reshape(-1))
    assert out.shape == (_COND.size, 1)
    np.testing.assert_array_equal(out[:len(flat), 0].numpy(), flat)
    assert (out[len(flat):] == -1).all()


def test_argsort_ties_keep_index_order():
    """Equal keys stay in index order in both directions (-x for
    descending, as JAX)."""
    for desc in (False, True):
        idx = _torch_run("argsort", {"X": _TIES},
                         {"descending": desc})["Indices"][0].numpy()
        key = -_TIES if desc else _TIES
        np.testing.assert_array_equal(
            idx, np.argsort(key, axis=-1, kind="stable"))


@pytest.mark.parametrize("sparse,pad", [(False, -1), (False, 3), (True, 3)])
def test_lookup_table_v2_grad_matches_jax(sparse, pad):
    """The shared embedding grad: a scatter-add of the out-grad rows, or a
    SelectedRows with is_sparse; padding_idx rows get none."""
    w = _f(10, 4)
    ids = np.array([[1, 3, 3], [0, 9, 3]], np.int64)
    og = _f(2, 3, 4)
    attrs = {"padding_idx": pad, "is_sparse": sparse}
    jg = jreg._REGISTRY["lookup_table_v2"].grad_lower(
        jreg.LowerContext(), {"W": [jnp.asarray(w)], "Ids": [jnp.asarray(ids)],
                              "Out@GRAD": [jnp.asarray(og)]}, attrs)
    tg = treg._REGISTRY["lookup_table_v2"].grad_lower(
        treg.LowerContext(), {"W": [torch.from_numpy(w)],
                              "Ids": [torch.from_numpy(ids)],
                              "Out@GRAD": [torch.from_numpy(og)]}, attrs)
    j, t = jg["W@GRAD"][0], tg["W@GRAD"][0]
    if sparse:
        assert isinstance(j, JSR)
        np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
        np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values),
                                   rtol=OUT_TOL, atol=OUT_TOL)
        assert t.height == j.height
    else:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=OUT_TOL,
                                   atol=OUT_TOL)


def test_range_raises_as_jax():
    ins = {"Start": np.array([0.0], np.float32),
           "End": np.array([5.0], np.float32),
           "Step": np.array([1.0], np.float32)}
    with pytest.raises(NotImplementedError):
        _jax_run("range", ins, {})
    with pytest.raises(NotImplementedError):
        _torch_run("range", ins, {})


def test_py_func_rule_runs_the_function_on_numpy():
    """py_func's rule: the inputs reach the function as numpy arrays, its
    results come back in the declared dtypes and shapes (meta too); a
    wrong shape raises. (Against JAX's py_func in a program:
    test_torch_core_layers.py.)"""
    from paddle_tpu_torch.ops.tensor_ops import register_py_func

    def fn(a, b):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        return np.tanh(a) * 2, (b.sum(axis=0) > 0)

    x, y = _f(3, 4), _f(2, 4)
    attrs = {"out_shapes": [[3, 4], [4]], "out_dtypes": ["float32", "int32"],
             "func_id": register_py_func(fn)}
    out = _torch_run("py_func", {"X": [x, y]}, attrs)["Out"]
    meta = _torch_run("py_func", {"X": [x, y]}, attrs, device="meta")["Out"]
    assert [o.dtype for o in out] == [torch.float32, torch.int32]
    assert [m.shape for m in meta] == [o.shape for o in out]
    np.testing.assert_array_equal(out[0].numpy(), np.tanh(x) * 2)
    np.testing.assert_array_equal(out[1].numpy(), y.sum(axis=0) > 0)
    with pytest.raises(ValueError):
        _torch_run("py_func", {"X": [x, y]},
                   dict(attrs, out_shapes=[[4, 3], [4]]))


# ---------------------------------------------------------------------------
# random ops: statistics, not streams
# ---------------------------------------------------------------------------

def _draw(op, attrs, seed=0, ins=None):
    return _torch_run(op, ins or {}, attrs, seed=seed)


def test_truncated_gaussian_random_statistics():
    n, mean, std = 100000, 1.0, 2.0
    attrs = {"shape": [n], "mean": mean, "std": std, "dtype": "float32"}
    a = _draw("truncated_gaussian_random", attrs)["Out"][0]
    b = _draw("truncated_gaussian_random", attrs)["Out"][0]
    c = _draw("truncated_gaussian_random", attrs, seed=1)["Out"][0]
    assert a.shape == (n,) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    z = (a.numpy().astype(np.float64) - mean) / std
    assert z.min() > -2.0 and z.max() < 2.0
    # N(0, 1) truncated to [-2, 2]: mean 0, std 0.87962566
    assert abs(z.mean()) < 4 * 0.88 / np.sqrt(n)
    assert abs(z.std() - 0.87962566) < 0.01
    j = np.asarray(_jax_run("truncated_gaussian_random", {}, attrs)["Out"][0])
    jz = (j.astype(np.float64) - mean) / std
    assert abs(jz.std() - z.std()) < 0.02


def test_randint_and_shuffle_batch():
    attrs = {"shape": [100000], "low": -3, "high": 5, "dtype": "int64"}
    a = _draw("randint", attrs)["Out"][0]
    assert a.dtype == torch.int64 and a.shape == (100000,)
    assert int(a.min()) == -3 and int(a.max()) == 4
    counts = np.bincount(a.numpy() + 3, minlength=8)
    assert np.abs(counts / 100000 - 1 / 8).max() < 0.01
    assert torch.equal(a, _draw("randint", attrs)["Out"][0])
    x = _f(7, 3)
    s = _draw("shuffle_batch", {}, ins={"X": x})
    perm = s["ShuffleIdx"][0].numpy()
    assert sorted(perm.tolist()) == list(range(7))
    np.testing.assert_array_equal(s["Out"][0].numpy(), x[perm])
    j = _jax_run("shuffle_batch", {"X": x}, {})
    assert sorted(np.asarray(j["ShuffleIdx"][0]).tolist()) == list(range(7))


# ---------------------------------------------------------------------------
# nn: convolutions, pooling, interpolation, norms, losses
# ---------------------------------------------------------------------------

def _conv_t(cid, op, x, w, s, p, d, g):
    return _case(cid, op, {"Input": x, "Filter": w},
                 {"strides": s, "paddings": p, "dilations": d, "groups": g})


_NN_CASES = [
    _conv_t("conv2d_transpose", "conv2d_transpose", _f(2, 4, 5, 6),
            _f(4, 3, 3, 3), [1, 1], [0, 0], [1, 1], 1),
    _conv_t("conv2d_transpose_s2_p1_g2", "conv2d_transpose", _f(2, 4, 5, 6),
            _f(4, 3, 4, 4), [2, 2], [1, 1], [1, 1], 2),
    _conv_t("conv2d_transpose_d2", "conv2d_transpose", _f(1, 4, 5, 4),
            _f(4, 2, 3, 3), [2, 1], [1, 2], [2, 2], 2),
    _case("conv3d", "conv3d", {"Input": _f(2, 3, 5, 6, 6),
                               "Filter": _f(4, 3, 3, 3, 3)},
          {"strides": [1, 2, 2], "paddings": [1, 1, 1],
           "dilations": [1, 1, 1], "groups": 1}),
    _case("conv3d_asym_g2", "conv3d", {"Input": _f(1, 4, 5, 5, 6),
                                       "Filter": _f(4, 2, 2, 3, 3)},
          {"strides": [1, 1, 2], "paddings": [0, 1, 1, 0, 2, 1],
           "dilations": [2, 1, 1], "groups": 2}),
    _conv_t("conv3d_transpose", "conv3d_transpose", _f(1, 4, 3, 4, 4),
            _f(4, 3, 3, 3, 3), [2, 2, 2], [1, 1, 1], [1, 1, 1], 1),
    _conv_t("conv3d_transpose_g2_d2", "conv3d_transpose", _f(1, 4, 3, 3, 4),
            _f(4, 2, 2, 3, 3), [2, 1, 2], [0, 1, 1], [2, 2, 1], 2),
    _case("pool3d_max", "pool3d", {"X": _f(2, 3, 5, 6, 7)},
          {"pooling_type": "max", "ksize": [2, 3, 3], "strides": [2, 2, 2],
           "paddings": [0, 1, 1]}),
    _case("pool3d_max_ceil", "pool3d", {"X": _f(2, 3, 5, 6, 7)},
          {"pooling_type": "max", "ksize": [2, 2, 3], "strides": [2, 2, 2],
           "paddings": [0, 0, 1], "ceil_mode": True}),
    _case("pool3d_avg_exclusive_ceil", "pool3d", {"X": _f(2, 3, 5, 6, 7)},
          {"pooling_type": "avg", "ksize": [3, 3, 3], "strides": [2, 2, 2],
           "paddings": [1, 1, 1], "ceil_mode": True, "exclusive": True}),
    _case("pool3d_avg_inclusive", "pool3d", {"X": _f(2, 3, 5, 6, 7)},
          {"pooling_type": "avg", "ksize": [3, 3, 3], "strides": [2, 2, 2],
           "paddings": [1, 1, 1], "exclusive": False}),
    _case("pool3d_global", "pool3d", {"X": _f(2, 3, 4, 5, 6)},
          {"pooling_type": "avg", "ksize": [1, 1, 1],
           "global_pooling": True}),
    _case("adaptive_avg_divisible", "adaptive_pool2d", {"X": _f(2, 3, 8, 6)},
          {"pooling_size": [4, 3], "pooling_type": "avg"}),
    _case("adaptive_max_divisible", "adaptive_pool2d", {"X": _f(2, 3, 8, 6)},
          {"pooling_size": [4, 3], "pooling_type": "max"}),
    _case("adaptive_avg_ragged", "adaptive_pool2d", {"X": _f(2, 3, 7, 10)},
          {"pooling_size": [3, 4], "pooling_type": "avg"}),
    _case("adaptive_max_ragged", "adaptive_pool2d", {"X": _f(2, 3, 7, 10)},
          {"pooling_size": [3, 4], "pooling_type": "max"}),
    _case("pool2d_adaptive_avg", "pool2d", {"X": _f(2, 3, 7, 10)},
          {"pooling_type": "avg", "ksize": [3, 4], "adaptive": True}),
    _case("pool2d_adaptive_max_nhwc", "pool2d", {"X": _f(2, 7, 10, 3)},
          {"pooling_type": "max", "ksize": [3, 4], "adaptive": True,
           "data_format": "NHWC"}),
    _case("group_norm", "group_norm",
          {"X": _f(2, 6, 3, 4), "Scale": _f(6), "Bias": _f(6)},
          {"groups": 3, "epsilon": 1e-5}),
    _case("group_norm_plain", "group_norm", {"X": _f(2, 4, 3, 3)},
          {"groups": 2}),
    _case("instance_norm", "instance_norm",
          {"X": _f(2, 3, 4, 5), "Scale": _f(3), "Bias": _f(3)}),
    _case("lrn_n5", "lrn", {"X": _f(2, 7, 3, 3)}),
    _case("lrn_n3", "lrn", {"X": _f(2, 6, 3, 3)},
          {"n": 3, "k": 1.0, "alpha": 0.01, "beta": 0.5}),
    _case("prelu_all", "prelu", {"X": _f(2, 3, 4), "Alpha": _f(1)}),
    _case("prelu_channel", "prelu", {"X": _f(2, 3, 4, 2), "Alpha": _f(3)},
          {"mode": "channel"}),
    _case("prelu_element", "prelu", {"X": _f(2, 3, 4), "Alpha": _f(3, 4)},
          {"mode": "element"}),
    _case("spectral_norm", "spectral_norm",
          {"Weight": _f(4, 6), "U": _f(4), "V": _f(6)}),
    _case("spectral_norm_dim1_iters2", "spectral_norm",
          {"Weight": _f(3, 5, 2), "U": _f(5), "V": _f(6)},
          {"dim": 1, "power_iters": 2}),
    _case("cross_entropy", "cross_entropy",
          {"X": _u(0.05, 1.0, 4, 6), "Label": np.array(
              [[1], [5], [-100], [0]], np.int64)}),
    _case("cross_entropy_soft", "cross_entropy",
          {"X": _u(0.05, 1.0, 4, 6), "Label": _u(0, 1, 4, 6)},
          {"soft_label": True}),
    _case("sigmoid_xent", "sigmoid_cross_entropy_with_logits",
          {"X": _f(4, 5), "Label": _u(0, 1, 4, 5)}),
    _case("sigmoid_xent_ignore_norm", "sigmoid_cross_entropy_with_logits",
          {"X": _f(4, 5), "Label": np.where(_R.rand(4, 5) < 0.3, -1.0,
                                            _R.randint(0, 2, (4, 5))
                                            ).astype(np.float32)},
          {"ignore_index": -1, "normalize": True}),
    _case("huber_loss", "huber_loss", {"X": _f(5, 3), "Y": _f(5, 3)},
          {"delta": 0.7}),
    _case("smooth_l1", "smooth_l1_loss", {"X": _f(4, 3, 2), "Y": _f(4, 3, 2)},
          {"sigma": 1.5}),
    _case("smooth_l1_weights", "smooth_l1_loss",
          {"X": _f(4, 3), "Y": _f(4, 3), "InsideWeight": _pos(4, 3),
           "OutsideWeight": _pos(4, 3)}),
] + [
    _case(f"kldiv_{r}", "kldiv_loss", {"X": _f(3, 4), "Target": _pos(3, 4)},
          {"reduction": r}) for r in ("mean", "sum", "batchmean", "none")
] + [
    _case(f"dropout_mask_apply_{impl}_{t}", "dropout_mask_apply",
          {"X": _f(3, 4), "Mask": (_R.rand(3, 4) > 0.3).astype(np.uint8)},
          {"dropout_prob": 0.3, "dropout_implementation": impl,
           "is_test": t})
    for impl in ("downgrade_in_infer", "upscale_in_train")
    for t in (False, True)
]


@_family(_NN_CASES)
def test_nn_ops_match_jax(k):
    _check(_NN_CASES, k)


# every direction and both coordinate rules of the 2-D interpolations:
# the corner grid (align_corners, where align_mode plays no part), or
# align_mode 0 and 1 without it; out_h/out_w or scale
_INTERP_CASES = [
    _case(f"{op}_{tag}_ac{int(ac)}_am{am}", op, {"X": x},
          dict(size, align_corners=ac, align_mode=am))
    for op in ("bilinear_interp", "nearest_interp")
    for tag, x, size in (("up", _f(2, 3, 4, 5), {"out_h": 7, "out_w": 12}),
                         ("down", _f(1, 2, 9, 8), {"out_h": 4, "out_w": 3}),
                         ("scale", _f(1, 2, 4, 3), {"scale": 2.0}))
    for ac, am in ((True, 1), (False, 0), (False, 1))
]
_INTERP_CASES += [
    _case(f"trilinear_{tag}_ac{int(ac)}", "trilinear_interp", {"X": x},
          dict(size, align_corners=ac))
    for tag, x, size in (
        ("up", _f(1, 2, 3, 4, 5), {"out_d": 5, "out_h": 7, "out_w": 9}),
        ("down", _f(1, 2, 9, 8, 10), {"out_d": 4, "out_h": 3, "out_w": 6}),
        ("mixed", _f(2, 1, 4, 6, 5), {"out_d": 7, "out_h": 6, "out_w": 2}))
    for ac in (True, False)
]


@_family(_INTERP_CASES)
def test_interp_ops_match_jax(k):
    _check(_INTERP_CASES, k)


def test_spectral_norm_three_runs_match_jax():
    """U and V carried across three runs (the op's write-back), every
    run's Out, UOut and VOut against JAX's."""
    w = _f(5, 4, 3)
    ju, jv = _f(5), _f(12)
    tu, tv = ju, jv
    for _ in range(3):
        j = _jax_run("spectral_norm", {"Weight": w, "U": ju, "V": jv}, {})
        t = _torch_run("spectral_norm", {"Weight": w, "U": tu, "V": tv}, {})
        for slot in ("Out", "UOut", "VOut"):
            np.testing.assert_allclose(t[slot][0].numpy(),
                                       np.asarray(j[slot][0]),
                                       rtol=OUT_TOL, atol=OUT_TOL)
        ju, jv = np.asarray(j["UOut"][0]), np.asarray(j["VOut"][0])
        tu, tv = t["UOut"][0].numpy(), t["VOut"][0].numpy()


# ---------------------------------------------------------------------------
# the misc and extra ops the layer files append
# ---------------------------------------------------------------------------

_MISC_CASES = [
    _case("linspace", "linspace", {"Start": np.array([-1.5], np.float32),
                                   "Stop": np.array([2.25], np.float32)},
          {"num": 7}),
    _case("linspace_one", "linspace", {"Start": np.array([3.0], np.float32),
                                       "Stop": np.array([4.0], np.float32)},
          {"num": 1}),
    _case("shard_index", "shard_index", {"X": _i(20, 6, 1)},
          {"index_num": 20, "nshards": 3, "shard_id": 1,
           "ignore_value": -1}),
    _case("diag", "diag", {"Diagonal": _f(4)}),
    _case("cos_sim", "cos_sim", {"X": _f(4, 5), "Y": _f(4, 5)}),
    _case("cos_sim_bcast", "cos_sim", {"X": _f(4, 5), "Y": _f(1, 5)}),
    _case("isnan", "isnan", {"X": np.array([1.0, np.nan], np.float32)}),
    _case("isinf_no", "isinf", {"X": _f(3)}),
    _case("isinf", "isinf", {"X": np.array([1.0, -np.inf], np.float32)}),
    _case("eye", "eye", {}, {"num_rows": 3, "num_columns": 5}),
    _case("eye_square", "eye", {}, {"num_rows": 4, "dtype": "float32"}),
    _case("label_smooth", "label_smooth", {"X": _u(0, 1, 3, 5)},
          {"epsilon": 0.1}),
    _case("label_smooth_prior", "label_smooth",
          {"X": _u(0, 1, 3, 5), "PriorDist": _u(0, 1, 5)},
          {"epsilon": 0.2}),
    _case("reverse", "reverse", {"X": _f(3, 4, 2)}, {"axis": [0, 2]}),
]


@_family(_MISC_CASES)
def test_misc_ops_match_jax(k):
    _check(_MISC_CASES, k)


def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().strip()


def test_print_op_writes_jax_format():
    """The print rule's lines in jax.debug.print's format: numpy's scalar
    and array formatting of the f32 mean, the min and max in X's dtype and
    the first `summarize` values; raw values without the stats; nothing
    at build time. (Against JAX's own lines in a program:
    test_torch_core_layers.py.)"""
    x = np.array([[1.5, -2.0, 3.25], [4.0, 5.0, 6.125]], np.float32)
    stats = {"message": "stats", "summarize": 20, "print_tensor_stats": True}
    assert _printed(lambda: _torch_run("print", {"X": x}, stats)) == (
        "stats shape=(2, 3) mean=2.9791667461395264 min=-2.0 max=6.125 "
        "first=[ 1.5   -2.     3.25   4.     5.     6.125]")
    raw = {"message": "raw", "summarize": 4, "print_tensor_stats": False}
    assert _printed(lambda: _torch_run("print", {"X": x}, raw)) == \
        "raw [ 1.5  -2.    3.25  4.  ]"
    ints = {"message": "ints", "summarize": 3, "print_tensor_stats": True}
    line = _printed(lambda: _torch_run("print", {"X": x.astype(np.int32)},
                                       ints))
    assert re.fullmatch(r"ints shape=\(2, 3\) mean=2\.83333\d+ min=-2 max=6 "
                        r"first=\[ 1 -2  3\]", line), line
    out = _torch_run("print", {"X": x}, stats)["Out"][0]
    np.testing.assert_array_equal(out.numpy(), x)
    assert _printed(lambda: _torch_run("print", {"X": x}, stats,
                                       device="meta")) == ""
