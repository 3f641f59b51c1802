"""The control-flow programs of the JAX package's tests/test_control_flow.py
and tests/test_control_flow_grad.py, and the GradientMerge program of
tests/test_parallel_extras.py:87, as builders over a package argument.

Each `build(pkg)` appends to the current program_guard of `pkg` (this
package, or any package with the same layers DSL) and returns (fetch
vars, number of leading output fetches; the rest are gradients).
`PROGRAMS` lists (id, build, feeds). tests/test_torch_control_flow.py
runs them through both packages on the CPU; chip_smoke.py's phase 4j runs
them on the card against the CPU.
"""

import numpy as np


def f32(*v):
    return np.array(v, np.float32)


def while_sums_to_ten(pkg):
    L = pkg.layers
    i = L.fill_constant([1], "int32", 0)
    i.stop_gradient = True
    limit = L.fill_constant([1], "int32", 10)
    total = L.fill_constant([1], "float32", 0.0)
    cond_v = L.less_than(i, limit)
    w = L.While(cond_v)
    with w.block():
        L.assign(L.elementwise_add(total, L.cast(i, "float32")),
                 output=total)
        L.assign(L.elementwise_add(i, L.fill_constant([1], "int32", 1)),
                 output=i)
        L.assign(L.less_than(i, limit), output=cond_v)
    return [total, i], 2


def doubling(pkg, bound=None, limit=100.0, grad=False):
    L = pkg.layers
    x = L.data("x", [1], append_batch_size=False)
    x.stop_gradient = not grad

    def cond_fn(v):
        return L.less_than(v, L.fill_constant([1], "float32", limit))

    out, = L.while_loop(cond_fn, lambda v: L.scale(v, scale=2.0), [x],
                        max_trip_count=bound)
    if not grad:
        return [out], 1
    gx, = pkg.gradients([L.reduce_sum(out)], [x])
    return [out, gx], 1


def nonlinear_loop(pkg):
    L = pkg.layers
    x = L.data("x", [3], append_batch_size=False)
    x.stop_gradient = False
    i = L.fill_constant([1], "int32", 0)
    i.stop_gradient = True
    n = L.fill_constant([1], "int32", 4)
    state = L.assign(x)
    state.stop_gradient = False
    cv = L.less_than(i, n)
    w = L.While(cv, max_trip_count=8)
    with w.block():
        L.assign(L.tanh(L.scale(state, scale=1.3)), output=state)
        L.assign(L.elementwise_add(i, L.fill_constant([1], "int32", 1)),
                 output=i)
        L.assign(L.less_than(i, n), output=cv)
    loss = L.reduce_sum(L.square(state))
    gx, = pkg.gradients([loss], [x])
    return [loss, gx], 1


def cond_branches(pkg, grad=False):
    L = pkg.layers
    x = L.data("x", [2], append_batch_size=False)
    x.stop_gradient = not grad
    p = L.data("p", [1], append_batch_size=False)
    pred = L.greater_than(p, L.fill_constant([1], "float32", 0.0))
    out = L.cond(pred, lambda: L.scale(x, scale=3.0),
                 lambda: L.scale(x, scale=-2.0))
    if not grad:
        return [out], 1
    loss = L.reduce_sum(out)
    gx, = pkg.gradients([loss], [x])
    return [loss, gx], 1


def switch_lr(pkg):
    L = pkg.layers
    step = L.data("step", [1], append_batch_size=False)
    lr = L.fill_constant([1], "float32", 0.0)
    b1 = L.fill_constant([1], "float32", 10.0)
    with L.Switch() as sw:
        with sw.case(L.less_than(step, b1)):
            L.assign(L.fill_constant([1], "float32", 0.1), output=lr)
        with sw.default():
            L.assign(L.fill_constant([1], "float32", 0.01), output=lr)
    return [lr], 1


def switch_overwrite(pkg):
    L = pkg.layers
    x = L.data("x", [1], append_batch_size=False)
    x.stop_gradient = False
    w = L.scale(x, scale=3.0)
    c = L.data("c", [1], append_batch_size=False)
    pred = L.greater_than(c, L.fill_constant([1], "float32", 0.0))
    with L.Switch() as sw:
        with sw.case(pred):
            L.assign(L.fill_constant([1], "float32", 7.0), output=w)
    loss = L.reduce_sum(w)
    gx, = pkg.gradients([loss], [x])
    return [loss, gx], 1


def nested_whiles(pkg):
    L = pkg.layers
    x = L.data("x", [1], append_batch_size=False)
    x.stop_gradient = False

    def outer_body(v):
        u_out, = L.while_loop(
            lambda u: L.less_than(u, L.fill_constant([1], "float32", 10.0)),
            lambda u: L.scale(u, scale=2.0), [v], max_trip_count=6)
        return L.scale(u_out, scale=1.5)

    out, = L.while_loop(
        lambda v: L.less_than(v, L.fill_constant([1], "float32", 50.0)),
        outer_body, [x], max_trip_count=4)
    gx, = pkg.gradients([L.reduce_sum(out)], [x])
    return [out, gx], 1


def boundless_stopgrad(pkg):
    L = pkg.layers
    x = L.data("x", [1], append_batch_size=False)
    x.stop_gradient = False
    i = L.fill_constant([1], "int32", 0)
    i.stop_gradient = True
    n = L.fill_constant([1], "int32", 3)
    acc = L.fill_constant([1], "float32", 0.0)
    acc.stop_gradient = True
    cv = L.less_than(i, n)
    w = L.While(cv)
    with w.block():
        L.assign(L.elementwise_add(acc, L.fill_constant([1], "float32",
                                                        1.0)), output=acc)
        L.assign(L.elementwise_add(i, L.fill_constant([1], "int32", 1)),
                 output=i)
        L.assign(L.less_than(i, n), output=cv)
    loss = L.reduce_sum(L.elementwise_add(L.square(x), acc))
    gx, = pkg.gradients([loss], [x])
    return [loss, gx], 1


def ifelse(pkg, reduce=False):
    L = pkg.layers
    x = L.data("x", [4, 3], append_batch_size=False)
    x.stop_gradient = reduce
    m = L.data("m", [4, 1], dtype="bool", append_batch_size=False)
    ie = L.IfElse(m)
    with ie.true_block():
        ie.output(L.reduce_sum(ie.input(x), dim=[1]) if reduce
                  else L.scale(ie.input(x), scale=2.0))
    with ie.false_block():
        ie.output(L.reduce_max(ie.input(x), dim=[1]) if reduce
                  else L.scale(ie.input(x), scale=-1.0))
    merged, = ie()
    if reduce:
        return [merged], 1
    gx, = pkg.gradients([L.reduce_sum(merged)], [x])
    return [merged, gx], 1


_T, _B, _D, _H = 3, 2, 4, 5


def static_rnn(pkg):
    L = pkg.layers
    x = L.data("x", [_T, _B, _D], append_batch_size=False)
    x.stop_gradient = False
    boot = L.fill_constant([_B, _H], "float32", 0.0)
    rnn = L.StaticRNN()
    with rnn.step():
        inp = rnn.step_input(x)
        prev = rnn.memory(init=boot)
        h = L.fc(input=inp, size=_H, bias_attr=False)
        nxt = L.tanh(L.elementwise_add(h, prev))
        rnn.update_memory(prev, nxt)
        rnn.step_output(nxt)
    out = rnn()
    loss = L.reduce_mean(out)
    gx, = pkg.gradients([loss], [x])
    w = pkg.default_main_program().global_block.all_parameters()[0]
    gw = pkg.default_main_program().global_block.var(w.name + "@GRAD")
    return [loss, out, gx, gw], 2


def static_rnn_trains(pkg):
    L = pkg.layers
    x = L.data("x", [4, 3, 5], append_batch_size=False)
    boot = L.fill_constant([3, 7], "float32", 0.0)
    rnn = L.StaticRNN()
    with rnn.step():
        wd = rnn.step_input(x)
        prev = rnn.memory(init=boot)
        h = L.fc(input=[wd, prev], size=7, bias_attr=False, act="tanh")
        rnn.update_memory(prev, h)
        rnn.step_output(h)
    loss = L.reduce_mean(L.square(rnn()))
    pkg.optimizer.SGDOptimizer(learning_rate=0.5).minimize(loss)
    return [loss], 1


def memory_batch_ref(pkg):
    L = pkg.layers
    x = L.data("x", [3, 4, 2], append_batch_size=False)
    rnn = L.StaticRNN()
    with rnn.step():
        wd = rnn.step_input(x)
        prev = rnn.memory(shape=[6], batch_ref=wd, init_value=0.0)
        h = L.fc(input=[wd, prev], size=6, bias_attr=False)
        rnn.update_memory(prev, h)
        rnn.step_output(h)
    return [rnn()], 1


def dynamic_rnn(pkg):
    L = pkg.layers
    B, T, D, H = 3, 5, 4, 6
    x = L.data("x", [B, T, D], append_batch_size=False)
    lens = L.data("lens", [B], dtype="int32", append_batch_size=False)
    x.stop_gradient = False
    drnn = L.DynamicRNN()
    with drnn.block():
        wd = drnn.step_input(x, lens)
        prev = drnn.memory(shape=[H], value=0.0)
        h = L.fc(input=[wd, prev], size=H, bias_attr=False, act="tanh")
        drnn.update_memory(prev, h)
        drnn.output(h)
    out = drnn()
    gx, = pkg.gradients([L.reduce_sum(out)], [x])
    return [out, gx], 1


_R = np.random.RandomState(11)
_XS = np.arange(12, dtype=np.float32).reshape(4, 3)
_MASK = np.array([[True], [False], [True], [False]])

PROGRAMS = [
    ("while_sums_to_ten", while_sums_to_ten, [{}]),
    ("while_loop_functional", doubling, [{"x": f32(1.0)}]),
    ("cond_branches", cond_branches,
     [{"x": f32(3.0, 1.0), "p": f32(1.0)},
      {"x": f32(3.0, 1.0), "p": f32(-1.0)}]),
    ("switch_lr_style", switch_lr,
     [{"step": f32(5.0)}, {"step": f32(50.0)}]),
    ("geometric_loop_grad", lambda pkg: doubling(pkg, 16, grad=True),
     [{"x": f32(1.5)}]),
    ("nonlinear_loop_grad", nonlinear_loop,
     [{"x": f32(0.3, -0.7, 1.1)}]),
    ("switch_overwrite_grad", switch_overwrite,
     [{"x": f32(2.0), "c": f32(1.0)}, {"x": f32(2.0), "c": f32(-1.0)}]),
    ("nested_whiles_grad", nested_whiles, [{"x": f32(1.0)}]),
    ("boundless_stopgrad_while", boundless_stopgrad, [{"x": f32(3.0)}]),
    ("ifelse_rank1", lambda pkg: ifelse(pkg, reduce=True),
     [{"x": _XS, "m": _MASK}]),
    ("cond_grad", lambda pkg: cond_branches(pkg, grad=True),
     [{"x": f32(1.0, 2.0), "p": f32(1.0)},
      {"x": f32(1.0, 2.0), "p": f32(-1.0)}]),
    ("static_rnn_grads", static_rnn,
     [{"x": _R.randn(_T, _B, _D).astype(np.float32)}]),
    ("static_rnn_sgd_steps", static_rnn_trains,
     [{"x": np.random.RandomState(0).randn(4, 3, 5).astype(np.float32)}]
     * 4),
    ("static_rnn_batch_ref", memory_batch_ref,
     [{"x": np.ones((3, 4, 2), np.float32)}]),
    ("dynamic_rnn_lengths_grads", dynamic_rnn,
     [{"x": _R.randn(3, 5, 4).astype(np.float32),
       "lens": np.array([5, 2, 3], np.int32)}]),
    ("ifelse_rowwise_grads", ifelse, [{"x": _XS, "m": _MASK}]),
]




GM_K = 4


def gradient_merge_micro_batches(k=GM_K):
    """2k micro-batches of 8 rows of a linear target
    (tests/test_parallel_extras.py:87)."""
    rng = np.random.RandomState(3)
    w = np.arange(6, dtype=np.float32) / 6.0
    micro = []
    for _ in range(2 * k):  # 2 merged steps
        x = rng.randn(8, 6).astype(np.float32)
        micro.append({"x": x, "y": (x @ w[:, None]).astype(np.float32)})
    return micro


def gradient_merge_program(pkg, merge=True, k=GM_K):
    """fc(6 -> 1), squared error, SGD(0.1), under GradientMergeOptimizer
    (k_steps=k) when `merge`. Returns (main, startup, loss)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [6], dtype="float32")
        y = pkg.layers.data("y", [1], dtype="float32")
        pred = pkg.layers.fc(x, size=1)
        loss = pkg.layers.mean(pkg.layers.square(pred - y))
        opt = pkg.optimizer.SGD(learning_rate=0.1)
        if merge:
            opt = pkg.optimizer.GradientMergeOptimizer(opt, k_steps=k)
        opt.minimize(loss)
    main.random_seed = startup.random_seed = 7
    return main, startup, loss
