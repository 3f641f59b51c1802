"""The core layers' rest (`layers/{math,tensor,nn}.py`), the tensor-array
layers and `layers/distributions.py` of the PyTorch port against the JAX
package's, on the CPU, and the slice as a whole: a narrow DCGAN.

  * one program a layer file, built through both packages' `layers`:
    the programs equal op for op (types, slots, attrs; `_program_dict`);
    from the JAX startup values and the same seeded feeds, every fetched
    output within op_test's 1e-5 and every `append_backward` gradient
    within its 5e-3 (max relative error); random layers on shapes only.
    The tensor program holds the tensor-array layers inside a While,
    py_func with a numpy function and Print's captured line; the nn
    program runs three times, spectral_norm's U and V carried by the
    executor, each run's U, V and outputs against JAX's;
  * the distributions: each class's log_prob, entropy and kl_divergence
    on fed values against JAX; the samplers' moments at n = 1e5 (other
    streams than JAX's, ROADMAP §C);
  * a DCGAN with the layer kinds and stride pattern of Radford et al.
    (arXiv:1511.06434; paddle_tpu_torch/tools/dcgan_cases.py, built
    through each package) at ngf = ndf = 8 on 16x16 images, batch 4: three
    alternating D and G Adam steps (lr 2e-4, beta1 0.5) from JAX's
    startup values; every loss and every persistable within the
    gradient tolerance of JAX's;
  * hygiene: every layer name the slice ports exists; the two registries
    mark every shared op type alike (not_differentiable, grad_free,
    no_grad_inputs, non_diff_outputs, stateful, an own grad maker); the
    port imports neither jax nor paddle_tpu.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import registry as jreg
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.tools.dcgan_cases import dcgan_programs
from test_torch_gpt_inference import _program_dict
from torch_port_common import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_TOL = 1e-5
GRAD_TOL = 5e-3


def _op_test_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    denom = max(np.abs(a).max(initial=0), np.abs(b).max(initial=0), 1e-3)
    return np.abs(a - b).max(initial=0) / denom


def _programs_equal(jm, tm):
    """`_program_dict`s equal, py_func's func_id aside: each package
    numbers its own table of callables."""
    d = [_program_dict(m) for m in (jm, tm)]
    for prog in d:
        for b in prog["blocks"]:
            for op in b["ops"]:
                if op["type"] == "py_func":
                    op["attrs"].pop("func_id")
    return d[0] == d[1]


def _build(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        out = build(pkg)
    return main, startup, out


def _start_both(startup):
    """The startup values, run once by the port's executor (eager: no
    compile), as numpy; the JAX scope and the port's (through
    io.set_params_from_numpy) both start from them."""
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    init = {n: scope.find_var(n).numpy() for n in scope.var_names()
            if isinstance(scope.find_var(n), torch.Tensor)}
    jscope, tscope = pt.Scope(), ptt.Scope()
    for n, v in init.items():
        jscope.set_var(n, jnp.asarray(v))
    ptt.io.set_params_from_numpy(tscope, init, "cpu")
    return jscope, tscope, init


def _run_both(build, feed, runs=1, state=()):
    """Build with both DSLs; the programs (main and startup) must match.
    `build(pkg)` returns (fetched vars, vars whose gradients to fetch;
    the loss is their sum of means, appended with append_backward). From
    the JAX startup values, `runs` runs of each on `feed`. Returns per run
    (JAX fetches, port fetches, JAX state, port state), fetches as
    outputs then gradients, state the named persistables after it."""
    progs = []
    for pkg in (pt, ptt):
        def full(p):
            outs, wrt = build(p)
            loss = p.layers.sum([p.layers.reduce_mean(o) for o in outs
                                 if o.dtype == "float32"
                                 and not o.stop_gradient])
            p.append_backward(loss)
            return [o.name for o in outs] + [v.name + "@GRAD" for v in wrt]
        main, startup, fetch = _build(pkg, full)
        main.random_seed = startup.random_seed = 3
        progs.append((main, startup, fetch))
    (jm, js, jf), (tm, ts, tf) = progs
    assert _programs_equal(jm, tm)
    assert _program_dict(js) == _program_dict(ts)
    jscope, tscope, _ = _start_both(ts)
    jexe, texe = pt.Executor(), ptt.Executor(ptt.CPUPlace())
    res = []
    for _ in range(runs):
        j = [np.asarray(v) for v in jexe.run(jm, feed=feed, fetch_list=jf,
                                             scope=jscope)]
        t = [np.asarray(v) for v in texe.run(tm, feed=feed, fetch_list=tf,
                                             scope=tscope)]
        res.append((j, t, {n: np.asarray(jscope.find_var(n)) for n in state},
                    {n: np.asarray(tscope.find_var(n)) for n in state}))
    return res, jm, jf


def _check(j, t, n_out, skip=()):
    """Outputs (the first n_out) within 1e-5, gradients within op_test's
    5e-3; `skip` indexes random outputs, held on shape and dtype only."""
    for k, (a, b) in enumerate(zip(j, t)):
        assert b.shape == a.shape, (k, b.shape, a.shape)
        if k in skip:
            continue
        if k >= n_out:
            assert _op_test_rel(b, a) <= GRAD_TOL, (k, _op_test_rel(b, a))
        elif np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=OUT_TOL, atol=OUT_TOL,
                                       err_msg=str(k))
        else:
            np.testing.assert_array_equal(b, a, err_msg=str(k))


_R = np.random.RandomState(31)

# the JAX executor's programs are small: their XLA compile, not their run,
# is the cost, so each test here compiles them without LLVM's expensive
# passes (the JAX package itself is not changed)
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True)
def _fast_jax_compile(monkeypatch):
    jit = jax.jit

    def fast_jit(fn, **kw):
        kw.setdefault("compiler_options", _FAST_COMPILE)
        return jit(fn, **kw)

    monkeypatch.setattr(jax, "jit", fast_jit)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# layers/math.py
# ---------------------------------------------------------------------------

def _math_program(pkg):
    L = pkg.layers

    def d(name, shape):
        return L.data(name, shape, append_batch_size=False,
                      stop_gradient=False)

    x, y, p, w = d("x", [3, 4]), d("y", [3, 4]), d("p", [3, 4]), d("w", [4, 5])
    ge, ne = L.greater_equal(x, y), L.not_equal(x, y)
    outs = [L.elementwise_div(x, p), L.elementwise_min(x, y),
            L.elementwise_max(x, y), L.elementwise_pow(p, y),
            L.elementwise_floordiv(x, p), L.mul(x, w),
            L.sum([x, y, p]), L.sums([x, p]),
            L.reduce_min(x, dim=1), L.reduce_prod(p, dim=[0]),
            L.reduce_all(ge, dim=1), L.reduce_any(ne),
            L.clip_by_norm(x, 1.0), L.l2_normalize(y, axis=1),
            ge, ne, L.logical_and(ge, ne), L.logical_xor(ge, ne),
            L.isfinite(x), L.triu(x, 1)]
    return outs, [x, y, p, w]


def test_math_layers_match_jax():
    feed = {"x": _f(3, 4), "y": _f(3, 4),
            "p": (np.abs(_f(3, 4)) + 0.3), "w": _f(4, 5)}
    (res,), _, _ = _run_both(_math_program, feed)
    _check(res[0], res[1], n_out=20)


# ---------------------------------------------------------------------------
# layers/tensor.py, the tensor arrays inside a While, py_func, Print
# ---------------------------------------------------------------------------

def _py_fn(a):
    return np.tanh(np.asarray(a)) * 2.0


def _tensor_program(pkg):
    L = pkg.layers
    blk = pkg.default_main_program().global_block
    x = L.data("x", [4, 3], append_batch_size=False, stop_gradient=False)
    upd = L.data("upd", [2, 3], append_batch_size=False, stop_gradient=False)
    idx = L.data("idx", [3], dtype="int64", append_batch_size=False)
    nd = L.data("nd", [2, 2], dtype="int64", append_batch_size=False)
    ids = L.data("ids", [2], dtype="int64", append_batch_size=False)
    col = L.data("col", [5, 1], dtype="int64", append_batch_size=False)
    dv = L.data("dv", [3], append_batch_size=False)
    so, si = L.argsort(x, axis=1, descending=True)
    made = L.create_tensor("float32", name="made")
    L.assign(L.scale(x, scale=3.0), output=made)
    py_out = blk.create_var(name="py_out", shape=(4, 3), dtype="float32",
                            stop_gradient=True)
    L.py_func(_py_fn, x, py_out)
    outs = [L.zeros([2, 3]), L.ones([2, 3]), L.zeros_like(x),
            L.ones_like(x), L.stack([x, L.scale(x, scale=2.0)], axis=1),
            *L.unstack(x, axis=1), L.gather(x, idx), L.gather_nd(x, nd),
            L.scatter(x, ids, upd), L.expand(x, [2, 1]), L.tile(x, [1, 2]),
            L.flip(x, 0), L.roll(x, 1, 0), L.shape(x), L.size(x),
            L.argmin(x, axis=1), so, si, L.pad(x, [1, 0, 0, 2], 0.5),
            L.pad2d(L.reshape(x, [1, 1, 4, 3]), [1, 1, 2, 0],
                    mode="reflect"),
            L.diag(dv), L.eye(3, 4), L.linspace(0.0, 1.0, 5),
            L.range(0, 6, 2), L.reverse(x, 1), L.sign(x),
            L.flatten(L.reshape(x, [2, 2, 3]), axis=2), L.has_inf(x),
            L.has_nan(x), L.isfinite(x),
            L.shard_index(col, index_num=10, nshards=2, shard_id=1),
            made, py_out, L.Print(x, message="tensor x", summarize=5)]
    # the tensor-array layers inside a While: element 1 updated three
    # times at a static index
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 3)
    arr = L.array_write(x, L.fill_constant([1], "int64", 0))
    L.array_write(L.scale(x, scale=-1.0), L.fill_constant([1], "int64", 1),
                  array=arr)
    cond = L.less_than(i, n)
    loop = L.While(cond)
    with loop.block():
        k = L.fill_constant([1], "int64", 1)
        cur = L.array_read(arr, k, shape=[4, 3])
        L.array_write(L.elementwise_add(L.scale(cur, scale=0.5), x), k,
                      array=arr)
        L.increment(i, in_place=True)
        L.assign(L.less_than(i, n), output=cond)
    stacked, _ = L.tensor_array_to_tensor(arr, axis=0, use_stack=True)
    for v in (L.array_length(arr), stacked,
              L.array_read(arr, L.fill_constant([1], "int64", 1),
                           shape=[4, 3])):
        v.stop_gradient = True
        outs.append(v)
    rand = [L.uniform_random([2, 3]), L.gaussian_random([2, 3])]
    return outs + rand, [x, upd]


def test_tensor_layers_match_jax(capfd):
    x = _f(4, 3)
    x[1, 2] = x[1, 0]        # a tie for argsort and argmin
    feed = {"x": x, "upd": _f(2, 3),
            "idx": np.array([3, 0, 3], np.int64),
            "nd": np.array([[1, 2], [3, 0]], np.int64),
            "ids": np.array([2, 0], np.int64),
            "col": np.array([[0], [4], [5], [9], [7]], np.int64),
            "dv": _f(3)}
    capfd.readouterr()
    (res,), _, names = _run_both(_tensor_program, feed)
    jax.effects_barrier()
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("tensor x")]
    n_out = len(res[0]) - 2
    _check(res[0], res[1], n_out=n_out, skip={n_out - 2, n_out - 1})
    j, t = res[0], res[1]
    np.testing.assert_allclose(t[names.index("py_out")], _py_fn(x),
                               rtol=1e-6)
    assert int(t[n_out - 5][0]) == 2          # array_length
    # each package prints in the forward and in the grad's replay; the
    # lines equal but for the f32 mean, within 1e-6
    assert len(lines) == 4, lines
    means = [float(re.search(r" mean=(\S+)", ln).group(1)) for ln in lines]
    assert max(means) / min(means) - 1 < 1e-6
    assert len({re.sub(r" mean=\S+", "", ln) for ln in lines}) == 1, lines


# ---------------------------------------------------------------------------
# layers/nn.py, spectral_norm's U and V over three runs
# ---------------------------------------------------------------------------

def _nn_program(pkg):
    L = pkg.layers

    def d(name, shape):
        return L.data(name, shape, append_batch_size=False,
                      stop_gradient=False)

    img, vol, logits = d("img", [2, 4, 6, 6]), d("vol", [1, 2, 4, 6, 6]), \
        d("logits", [3, 5])
    tgt, snw = d("tgt", [3, 5]), d("snw", [4, 6])
    label = L.data("label", [3, 1], dtype="int64", append_batch_size=False)
    c3 = L.conv3d(vol, 3, 3, padding=1, act="relu")
    prob = L.softmax(logits)
    outs = [L.conv2d_transpose(img, 3, 4, stride=2, padding=1),
            L.conv2d_transpose(img, 4, 3, dilation=2, groups=2,
                               bias_attr=False),
            c3, L.conv3d_transpose(vol, 2, 2, stride=2),
            L.pool3d(c3, 2, "max", 2), L.pool3d(vol, 3, "avg", 2, 1,
                                                ceil_mode=True),
            L.group_norm(img, 2), L.instance_norm(img), L.lrn(img, n=3),
            L.prelu(img, mode="channel"), L.spectral_norm(snw),
            L.nn.resize_bilinear(img, out_shape=[9, 8],
                                 align_corners=False),
            L.nn.resize_nearest(img, scale=2.0),
            L.leaky_relu(img, 0.2), L.elu(img), L.softplus(img),
            L.swish(img), L.hard_sigmoid(img), L.exp(img),
            L.log(L.abs(img)), L.pow(img, 2.0), L.log_softmax(logits),
            L.cross_entropy(prob, label),
            L.sigmoid_cross_entropy_with_logits(logits, L.sigmoid(tgt)),
            L.huber_loss(logits, tgt, 0.5), L.smooth_l1(logits, tgt),
            L.mse_loss(logits, tgt),
            L.kldiv_loss(L.log_softmax(logits), L.softmax(tgt)),
            L.label_smooth(L.softmax(tgt), epsilon=0.1),
            L.cos_sim(logits, tgt)]
    return outs, [img, vol, logits, tgt, snw]


def test_nn_layers_match_jax_over_three_runs():
    feed = {"img": _f(2, 4, 6, 6), "vol": _f(1, 2, 4, 6, 6),
            "logits": _f(3, 5), "tgt": _f(3, 5), "snw": _f(4, 6),
            "label": np.array([[1], [4], [0]], np.int64)}
    state = ["snw.sn_u_0", "snw.sn_v_0"]
    res, jm, _ = _run_both(_nn_program, feed, runs=3, state=state)
    assert set(state) <= {v.name for v in jm.list_vars() if v.persistable}
    n_out = len(res[0][0]) - 5
    for j, t, js, ts in res:
        _check(j, t, n_out=n_out)
        for n in state:
            np.testing.assert_allclose(ts[n], js[n], rtol=OUT_TOL,
                                       atol=OUT_TOL)
    # the executor wrote U and V back: the runs' states differ
    assert not np.allclose(res[0][3][state[0]], res[2][3][state[0]])


# ---------------------------------------------------------------------------
# layers/distributions.py
# ---------------------------------------------------------------------------

def _dist_program(pkg):
    L, D = pkg.layers, pkg.layers.distributions

    def d(name, shape, dtype="float32"):
        return L.data(name, shape, dtype=dtype, append_batch_size=False)

    loc, scale, v = d("loc", [4, 3]), d("scale", [4, 3]), d("v", [4, 3])
    loc2, scale2 = d("loc2", [4, 3]), d("scale2", [4, 3])
    lg, lg2 = d("lg", [4, 5]), d("lg2", [4, 5])
    cls = d("cls", [4, 1], "int64")
    lo, hi = d("lo", [4, 3]), d("hi", [4, 3])
    n1, n2 = D.Normal(loc, scale), D.Normal(loc2, scale2)
    c1, c2 = D.Categorical(lg), D.Categorical(lg2)
    m1 = D.MultivariateNormalDiag(loc, scale)
    m2 = D.MultivariateNormalDiag(loc2, scale2)
    u = D.Uniform(lo, hi)
    outs = [n1.log_prob(v), n1.entropy(), n1.kl_divergence(n2),
            c1.log_prob(cls), c1.entropy(), c1.kl_divergence(c2),
            m1.log_prob(v), m1.entropy(), m1.kl_divergence(m2),
            u.log_prob(v), u.entropy()]
    for o in outs:
        o.stop_gradient = True
    return outs, []


def test_distributions_match_jax():
    pos = lambda *s: (np.abs(_f(*s)) + 0.2).astype(np.float32)  # noqa
    lo = _f(4, 3)
    feed = {"loc": _f(4, 3), "scale": pos(4, 3), "v": _f(4, 3),
            "loc2": _f(4, 3), "scale2": pos(4, 3), "lg": _f(4, 5),
            "lg2": _f(4, 5), "cls": np.array([[0], [4], [2], [2]], np.int64),
            "lo": lo, "hi": lo + pos(4, 3)}
    progs = [_build(pkg, _dist_program) for pkg in (pt, ptt)]
    assert _program_dict(progs[0][0]) == _program_dict(progs[1][0])
    j = pt.Executor().run(progs[0][0], feed=feed, fetch_list=progs[0][2][0],
                          scope=pt.Scope())
    t = ptt.Executor(ptt.CPUPlace()).run(
        progs[1][0], feed=feed, fetch_list=progs[1][2][0], scope=ptt.Scope())
    _check([np.asarray(a) for a in j], t, n_out=len(j))
    for pkg in (pt, ptt):
        D = pkg.layers.distributions
        with pytest.raises(NotImplementedError):
            D.Distribution().entropy()
        with pytest.raises(NotImplementedError):
            _build(pkg, lambda p: p.layers.distributions.Uniform(
                0.0, 1.0).kl_divergence(None))


def test_distribution_samplers_statistics():
    """Normal(1.5, 2) and Uniform(-1, 3) at n = 1e5 on the port: moments
    within 4 standard errors; equal draws for equal program seeds."""
    n = 100000

    def build(p):
        D = p.layers.distributions
        return [D.Normal(1.5, 2.0).sample([n], seed=0),
                D.Uniform(-1.0, 3.0).sample([n], seed=0)]

    draws = []
    for _ in range(2):
        main, startup, outs = _build(ptt, build)
        main.random_seed = 5
        draws.append(ptt.Executor(ptt.CPUPlace()).run(
            main, fetch_list=outs, scope=ptt.Scope()))
    (nv, uv), (nv2, uv2) = draws
    assert nv.shape == (n,) and uv.shape == (n,)
    np.testing.assert_array_equal(nv, nv2)
    np.testing.assert_array_equal(uv, uv2)
    assert abs(nv.mean() - 1.5) < 4 * 2.0 / np.sqrt(n)
    assert abs(nv.std() - 2.0) < 0.02
    assert uv.min() >= -1.0 and uv.max() < 3.0
    assert abs(uv.mean() - 1.0) < 4 * np.sqrt(16 / 12 / n)
    assert abs(uv.var() - 16 / 12) < 0.02


# ---------------------------------------------------------------------------
# the slice as a whole: a narrow DCGAN
# ---------------------------------------------------------------------------

NZ, NGF, NDF, IMG, BATCH = 16, 8, 8, 16, 4


def test_dcgan_three_steps_match_jax():
    rng = np.random.RandomState(4)
    (jp, js), (tp, ts) = [dcgan_programs(pkg, NZ, NGF, NDF, IMG)
                          for pkg in (pt, ptt)]
    for side in ("d", "g"):
        assert _program_dict(jp[side][0]) == _program_dict(tp[side][0])
    assert _program_dict(js) == _program_dict(ts)
    ops = {op.type for side in "dg" for op in tp[side][0].global_block.ops}
    assert {"conv2d_transpose", "leaky_relu", "fill_any_like",
            "fill_zeros_like", "sigmoid_cross_entropy_with_logits",
            "conv2d_transpose_grad", "leaky_relu_grad"} <= ops
    ts.random_seed = 9
    jscope, tscope, init = _start_both(ts)
    jexe, texe = pt.Executor(), ptt.Executor(ptt.CPUPlace())
    for step in range(3):
        real = np.tanh(rng.randn(BATCH, 3, IMG, IMG)).astype(np.float32)
        for side in ("d", "g"):
            feed = {"z": rng.randn(BATCH, NZ, 1, 1).astype(np.float32)}
            if side == "d":
                feed["real"] = real
            (jl,) = jexe.run(jp[side][0], feed=feed,
                             fetch_list=[jp[side][1]], scope=jscope)
            (tl,) = texe.run(tp[side][0], feed=feed,
                             fetch_list=[tp[side][1]], scope=tscope)
            assert np.isfinite(tl).all()
            assert _op_test_rel(tl, jl) <= GRAD_TOL, (step, side, tl, jl)
    assert len(init) > 20
    for n in sorted(init):
        a = np.asarray(tscope.find_var(n))
        b = np.asarray(jscope.find_var(n))
        assert _op_test_rel(a, b) <= GRAD_TOL, (n, _op_test_rel(a, b))


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------

SLICE_LAYERS = {
    "math": """elementwise_div elementwise_min elementwise_max
        elementwise_pow elementwise_floordiv mul sum sums reduce_min
        reduce_prod reduce_all reduce_any clip_by_norm l2_normalize
        not_equal greater_equal logical_and logical_xor isfinite
        triu""".split(),
    "tensor": """create_array array_write array_read array_length
        tensor_array_to_tensor py_func Print zeros ones zeros_like
        ones_like stack unstack gather gather_nd scatter expand tile flip
        roll shape size argmin argsort pad pad2d diag eye linspace range
        reverse sign flatten has_inf has_nan isfinite shard_index
        create_tensor uniform_random gaussian_random""".split(),
    "nn": """conv2d_transpose conv3d conv3d_transpose pool3d group_norm
        instance_norm lrn prelu spectral_norm resize_bilinear
        resize_nearest leaky_relu elu softplus swish hard_sigmoid exp log
        abs pow log_softmax cross_entropy
        sigmoid_cross_entropy_with_logits huber_loss smooth_l1 mse_loss
        kldiv_loss label_smooth cos_sim""".split(),
}


def test_layers_namespace_covers_the_slice():
    assert [len(v) for v in SLICE_LAYERS.values()] == [20, 40, 29]
    names = set(dir(ptt.layers))
    for mod, listed in SLICE_LAYERS.items():
        assert set(listed) <= names, set(listed) - names
        assert set(listed) <= set(getattr(ptt.layers, mod).__all__)
        assert set(getattr(pt.layers, mod).__all__) \
            == set(getattr(ptt.layers, mod).__all__)
    assert set(ptt.layers.distributions.__all__) == {
        "Distribution", "Uniform", "Normal", "Categorical",
        "MultivariateNormalDiag"}


def _own_ops(reg, package):
    """The op types a package's own modules register (tests of either
    package may register more in the same process)."""
    def rule(n):
        return reg._REGISTRY[n].lower or reg._MACROS.get(n) \
            or reg._HOST_OPS.get(n)
    return {n for n in reg._REGISTRY
            if rule(n).__module__.split(".")[0] == package}


def test_registries_mark_ops_alike():
    """Every op type both packages register is marked alike, so backward
    builds the same grad ops; the port registers 414 of the 427."""
    def marks(d):
        return (d.not_differentiable, d.grad_free, set(d.no_grad_inputs),
                set(d.non_diff_outputs), d.stateful, d.is_optimizer_op,
                d.grad_maker is not None)

    jown = _own_ops(jreg, "paddle_tpu")
    town = _own_ops(treg, "paddle_tpu_torch")
    assert town <= jown and len(town) == 414 and len(jown) == 427
    shared = jown & town
    diff = {n for n in shared
            if marks(jreg._REGISTRY[n]) != marks(treg._REGISTRY[n])}
    assert not diff, sorted(diff)


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports jax or
    paddle_tpu (read from their import statements)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "paddle_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|paddle_tpu)\b",
                     re.M)
    bad = []
    for path in files:
        with open(path) as f:
            bad += [(path, m) for m in pat.findall(f.read())]
    assert len(files) > 100 and not bad, bad
