"""The Switch MoE FFN of the PyTorch port and the ops it and the LR
schedules need, against the JAX package, on the CPU, at a small size.

  * the new ops as one-op programs through both executors, op_test
    style: one_hot, arg_max (ties to the first index), cumsum (exclusive,
    reverse, flatten), increment (the step keeps X's dtype),
    elementwise_min/pow, the compare and logical family, exp, pow, cos
    and the rounding ops: outputs within 1e-5 (the compares and the
    integer outputs exactly), declared shapes and dtypes equal (JAX
    without x64 declares int64 results as int32); the differentiable
    ones' input gradients within 5e-3 (`tests/op_test.py`'s tolerances);
  * `nets.switch_moe_ffn` at the shapes of tests/test_parallel_extras.py
    (:193, :264, :283, :294) on one device: programs op for op, the
    forward (out, aux) within 1e-5 and 3 Adam steps from the JAX startup
    values (losses within 1e-5 relative, parameters within 1e-5);
  * DGC momentum at sparsity 0 equals SGD (tests/test_parallel_extras.py
    :51), in the port and against JAX's DGC.
"""

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_book import build_both, carry_startup
from test_torch_gpt_inference import _program_dict
from test_torch_ops import _both, _int32, _run_grad
from torch_port_common import one_torch_thread  # noqa: F401


TOL = 1e-5
GRAD_TOL = 5e-3
_R = np.random.RandomState(16)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


_ties = np.array([[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0],
                  [0.0, -1.0, 0.0, -1.0]], np.float32)
_ids = np.array([[0], [3], [5], [2], [-1]], np.int64)
_cmp_x = np.round(_f(3, 5))
_cmp_y = np.round(_f(3, 5))
_bx = _R.rand(3, 5) > 0.5
_by = _R.rand(3, 5) > 0.5

# (case id, op type, inputs, output slots, attrs)
_CASES = [
    ("one_hot", "one_hot", {"X": _ids}, ["Out"], {"depth": 5}),
    ("one_hot_2d", "one_hot", {"X": _R.randint(0, 4, (2, 3))}, ["Out"],
     {"depth": 4}),
    ("arg_max_ties", "arg_max", {"X": _ties}, ["Out"], {"axis": -1}),
    ("arg_max_axis0_keep", "arg_max", {"X": _f(4, 3, 2)}, ["Out"],
     {"axis": 0, "keepdims": True}),
    ("cumsum", "cumsum", {"X": _f(2, 5, 3)}, ["Out"], {"axis": 1}),
    ("cumsum_exclusive", "cumsum", {"X": _f(2, 5, 3)}, ["Out"],
     {"axis": 1, "exclusive": True}),
    ("cumsum_reverse", "cumsum", {"X": _f(2, 5, 3)}, ["Out"],
     {"axis": -1, "reverse": True}),
    ("cumsum_exclusive_reverse", "cumsum", {"X": _f(4, 3)}, ["Out"],
     {"axis": 0, "exclusive": True, "reverse": True}),
    ("cumsum_flatten", "cumsum", {"X": _f(2, 3)}, ["Out"],
     {"flatten": True}),
    ("increment_f32", "increment", {"X": _f(1)}, ["Out"], {"step": 1.0}),
    ("increment_i64", "increment", {"X": np.array([7], np.int64)},
     ["Out"], {"step": 2.0}),
    ("elementwise_min", "elementwise_min", {"X": _f(3, 4), "Y": _f(3, 4)},
     ["Out"], {"axis": -1}),
    ("elementwise_min_axis", "elementwise_min", {"X": _f(2, 3, 4),
                                                 "Y": _f(3)},
     ["Out"], {"axis": 1}),
    ("elementwise_pow", "elementwise_pow",
     {"X": np.abs(_f(3, 4)) + 0.1, "Y": _f(3, 4)}, ["Out"], {"axis": -1}),
    ("elementwise_pow_scalar", "elementwise_pow",
     {"X": np.array([0.9], np.float32), "Y": np.array([2.5], np.float32)},
     ["Out"], {"axis": -1}),
] + [(name, name, {"X": _cmp_x, "Y": _cmp_y}, ["Out"], {})
     for name in ("equal", "not_equal", "less_than", "less_equal",
                  "greater_than", "greater_equal")] + [
    ("less_equal_bcast", "less_equal", {"X": _f(2, 3, 4),
                                        "Y": np.array([0.2], np.float32)},
     ["Out"], {}),
] + [(name, name, {"X": _bx, "Y": _by}, ["Out"], {})
     for name in ("logical_and", "logical_or", "logical_xor")] + [
    ("logical_not", "logical_not", {"X": _bx}, ["Out"], {}),
    ("exp", "exp", {"X": _f(3, 4)}, ["Out"], {}),
    ("cos", "cos", {"X": _f(3, 4) * 3}, ["Out"], {}),
    ("pow", "pow", {"X": np.abs(_f(3, 4)) + 0.1}, ["Out"],
     {"factor": -0.5}),
    ("pow_default", "pow", {"X": _f(3, 4)}, ["Out"], {}),
    ("floor", "floor", {"X": _f(3, 4) * 3}, ["Out"], {}),
    ("ceil", "ceil", {"X": _f(3, 4) * 3}, ["Out"], {}),
    ("round_half_even", "round",
     {"X": np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.7],
                    np.float32)}, ["Out"], {}),
    ("sign", "sign", {"X": np.array([-2.0, 0.0, 3.0, -0.0], np.float32)},
     ["Out"], {}),
]


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_new_op_matches_jax(case):
    _, op_type, inputs, outputs, attrs = case
    (jvals, jdecl), (tvals, tdecl) = _both(op_type, inputs, outputs, attrs)
    for n in jvals:
        assert (tdecl[n][0], _int32(tdecl[n][1])) == jdecl[n], n
        if jvals[n].dtype.kind in "biu":
            np.testing.assert_array_equal(tvals[n], jvals[n], err_msg=n)
        else:
            np.testing.assert_allclose(tvals[n], jvals[n], atol=TOL,
                                       rtol=TOL, err_msg=n)


_GRAD_CASES = [
    ("cumsum", "cumsum", {"X": _f(2, 5, 3)}, {"axis": 1}, ["X"]),
    ("cumsum_exclusive_reverse", "cumsum", {"X": _f(4, 3)},
     {"axis": 0, "exclusive": True, "reverse": True}, ["X"]),
    ("increment", "increment", {"X": _f(3)}, {"step": 1.0}, ["X"]),
    ("elementwise_min", "elementwise_min", {"X": _f(3, 4), "Y": _f(3, 4)},
     {"axis": -1}, ["X", "Y"]),
    ("elementwise_pow", "elementwise_pow",
     {"X": np.abs(_f(3, 4)) + 0.1, "Y": _f(3, 4)}, {"axis": -1},
     ["X", "Y"]),
    ("exp", "exp", {"X": _f(3, 4)}, {}, ["X"]),
    ("cos", "cos", {"X": _f(3, 4)}, {}, ["X"]),
    ("pow", "pow", {"X": np.abs(_f(3, 4)) + 0.1}, {"factor": -0.5}, ["X"]),
]


@pytest.mark.parametrize("case", _GRAD_CASES, ids=[c[0] for c in
                                                    _GRAD_CASES])
def test_new_op_grad_matches_jax(case):
    _, op_type, inputs, attrs, wrt = case
    jg, jdesc = _run_grad(pt, pt.Executor(), op_type, inputs, ["Out"],
                          attrs, "Out", wrt)
    tg, tdesc = _run_grad(ptt, ptt.Executor(ptt.CPUPlace()), op_type,
                          inputs, ["Out"], attrs, "Out", wrt)
    assert tdesc == jdesc
    assert len(tg) == len(jg) > 0
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t, j, atol=GRAD_TOL, rtol=GRAD_TOL)


# ---------------------------------------------------------------------------
# nets.switch_moe_ffn
# ---------------------------------------------------------------------------

# (id, experts, [s, d], d_ffn, capacity factor, batch, stacked layers)
_MOE = [
    ("trains_and_balances", 4, [8, 16], 32, 1.25, 4, 1),    # :193
    ("expert_parallel_one_device", 8, [8, 16], 32, 1.25, 8, 1),   # :264
    ("capacity_overflow", 2, [8, 4], 8, 0.5, 2, 1),         # :304
    ("stacked", 2, [4, 8], 16, 1.25, 3, 2),                 # :294
]


def _moe_build(experts, sd, d_ffn, cf, layers_n):
    def build(pkg):
        x = pkg.layers.data("x", sd, dtype="float32")
        y = pkg.layers.data("y", sd, dtype="float32")
        h, auxes = x, []
        for _ in range(layers_n):
            h, aux = pkg.nets.switch_moe_ffn(h, experts, sd[1], d_ffn,
                                             capacity_factor=cf)
            auxes.append(aux)
        mse = pkg.layers.mean(pkg.layers.square_error_cost(h, y))
        loss = mse
        for aux in auxes:
            loss = loss + pkg.layers.scale(aux, scale=0.01)
        return {"loss": loss, "out": h, "aux": auxes[0]}
    return build


def _adam(pkg):
    return pkg.optimizer.Adam(5e-3)


@pytest.mark.parametrize("case", _MOE, ids=[c[0] for c in _MOE])
def test_switch_moe_matches_jax(case):
    _, experts, sd, d_ffn, cf, batch, layers_n = case
    jprog, tprog = build_both(_moe_build(experts, sd, d_ffn, cf, layers_n),
                              _adam)
    assert _program_dict(tprog[0]) == _program_dict(jprog[0])
    assert _program_dict(tprog[1]) == _program_dict(jprog[1])
    expert_w = [p.name for p in tprog[0].all_parameters()
                if len(p.shape) == 3]
    assert len(expert_w) == 2 * layers_n == len(set(expert_w))
    (jmain, jstart, jspec), (tmain, _, tspec) = jprog, tprog
    jscope, tscope, persist = carry_startup(jmain, jstart)
    rng = np.random.RandomState(7)
    jexe, texe = pt.Executor(), ptt.Executor(ptt.CPUPlace())
    fetch = ["loss", "out", "aux"]
    for step in range(3):
        xv = rng.randn(batch, *sd).astype(np.float32)
        feed = {"x": xv, "y": np.tanh(xv)}
        j = jexe.run(jmain, feed=feed, fetch_list=[jspec[k] for k in fetch],
                     scope=jscope)
        t = texe.run(tmain, feed=feed, fetch_list=[tspec[k] for k in fetch],
                     scope=tscope)
        np.testing.assert_allclose(t[0], j[0], rtol=TOL, err_msg=step)
        for name, a, b in zip(fetch[1:], j[1:], t[1:]):
            np.testing.assert_allclose(b, a, atol=TOL, rtol=TOL,
                                       err_msg=f"{name} step {step}")
    for n in persist:
        np.testing.assert_allclose(tscope.get_numpy(n),
                                   np.asarray(jscope.find_var(n)),
                                   atol=TOL, rtol=1e-4, err_msg=n)


def test_moe_padding_tokens_single_expert():
    """All-zero tokens have uniform router probabilities; arg_max's first
    index sends each to ONE expert, so aux is exactly 1 (:283)."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name_guard(), ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [6, 8], dtype="float32")
        _, aux = ptt.nets.switch_moe_ffn(x, 4, 8, 16)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    av, = exe.run(main, feed={"x": np.zeros((2, 6, 8), np.float32)},
                  fetch_list=[aux], scope=scope)
    np.testing.assert_allclose(np.ravel(av)[0], 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# DGC at sparsity 0 == SGD
# ---------------------------------------------------------------------------

def _linear(pkg, make_opt):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [6], dtype="float32")
        y = pkg.layers.data("y", [1], dtype="float32")
        pred = pkg.layers.fc(x, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        make_opt(pkg).minimize(loss)
    main.random_seed = startup.random_seed = 11
    return main, startup, loss


def _feeds(steps, batch=16):
    rng = np.random.RandomState(0)
    w = np.arange(6, dtype=np.float32) / 6.0
    out = []
    for _ in range(steps):
        x = rng.randn(batch, 6).astype(np.float32)
        out.append({"x": x, "y": (x @ w[:, None]).astype(np.float32)})
    return out


def _losses(pkg, make_opt, init):
    """Losses of 6 steps from the program's startup, with the values of
    `init` carried over by name."""
    main, startup, loss = _linear(pkg, make_opt)
    exe = pt.Executor() if pkg is pt else ptt.Executor(ptt.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    init = {n: v for n, v in init.items() if main.global_block.has_var(n)}
    if pkg is pt:
        for n, v in init.items():
            scope.set_var(n, v)
    else:
        ptt.io.set_params_from_numpy(scope, init, "cpu")
    out = []
    for f in _feeds(6):
        lv, = exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        out.append(float(np.ravel(lv)[0]))
    return out


def test_dgc_sparsity_zero_equals_sgd():
    """Every element is sent each step and momentum-factor masking clears
    U, so DGC at sparsity 0 is plain SGD; the port's DGC also equals
    JAX's DGC."""
    def sgd(pkg):
        return pkg.optimizer.SGD(learning_rate=0.05)

    def dgc(pkg):
        return pkg.optimizer.DGCMomentumOptimizer(
            learning_rate=0.05, momentum=0.9, sparsity=0.0)

    jmain, jstart, _ = _linear(pt, dgc)
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    init = {v.name: np.asarray(jscope.find_var(v.name))
            for v in jmain.list_vars() if v.persistable
            and jscope.find_var(v.name) is not None}
    ref = _losses(ptt, sgd, init)
    port = _losses(ptt, dgc, init)
    np.testing.assert_allclose(port, ref, rtol=1e-6)
    np.testing.assert_allclose(port, _losses(pt, dgc, init), rtol=TOL)
    assert ref[-1] < ref[0]
