"""The ResNet slice of the PyTorch port against the JAX package, on the CPU.

  * the new ops (conv2d, depthwise_conv2d, pool2d, batch_norm, relu, top_k,
    accuracy, momentum) as one-op programs through both executors, op_test
    style: forward outputs within 1e-5 and input gradients within 5e-3 (the
    reference's op_test tolerances, `tests/op_test.py`); batch_norm also
    with bf16 input, at the tolerances stated in `test_batch_norm_bf16_*`;
  * bench_resnet50's train program (ResNet-50, 224x224, 1000 classes,
    Momentum(0.1, 0.9)) in fp32 and with the bf16 AMP rewrite: both DSLs
    build it op for op, slots, attrs and declared dtypes included, and the
    same startup program (build only);
  * 3 Momentum steps of `image_classification_program` (ResNet-20 for
    CIFAR-10) at batch 4 from the JAX startup values: losses, parameters,
    velocities and the BN running statistics;
  * full ResNet-50 at 224x224, batch 2, one step: the loss and all 161
    gradients;
  * AMP on a narrow bottleneck stack: the port's bf16 gradients against
    JAX's fp32 ones.

Max pooling after a ReLU meets ties (windows of zeros), and the two
frameworks may route the gradient to different zeros of a tie; parameter
gradients agree all the same (relu'(0) = 0 in both), so the model tests
compare those and never the pool's input gradient.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.tools import bench_resnet50 as bench
from test_torch_gpt_inference import _program_dict
from test_torch_ops import _both, _int32, _run_grad
from torch_port_common import executor, one_torch_thread  # noqa: F401


TOL = 1e-5          # op_test's output tolerance
GRAD_TOL = 5e-3     # op_test's gradient tolerance
BF16_ULP = 2.0 ** -7
_R = np.random.RandomState(11)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


def _conv(fmt="NCHW", strides=(1, 1), paddings=(0, 0), dilations=(1, 1),
          groups=1, **kw):
    return dict({"strides": list(strides), "paddings": list(paddings),
                 "dilations": list(dilations), "groups": groups,
                 "data_format": fmt}, **kw)


def _pool(ptype, ksize, strides=(1, 1), paddings=(0, 0), fmt="NCHW",
          ceil_mode=False, exclusive=True, global_pooling=False):
    return {"pooling_type": ptype, "ksize": list(ksize),
            "strides": list(strides), "paddings": list(paddings),
            "global_pooling": global_pooling, "ceil_mode": ceil_mode,
            "exclusive": exclusive, "data_format": fmt}


def _bn_inputs(x, c):
    return {"X": x, "Scale": _f(c), "Bias": _f(c), "Mean": _f(c) * 0.1,
            "Variance": np.abs(_f(c)) + 0.5}


_BN_OUT = ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"]


def _bn(is_test=False, layout="NCHW", **kw):
    return dict({"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
                 "data_layout": layout}, **kw)


_SCORES = _R.permutation(60).astype(np.float32).reshape(6, 10) / 7.0
_TOPI = np.argsort(-_SCORES, axis=1)[:, :3].astype(np.int64)

# (case id, op type, inputs, output slots, attrs, gradient target, wrt
# slots; no target: forward only)
_CASES = [
    ("conv_nchw_s2_pad", "conv2d",
     {"Input": _f(2, 3, 9, 9), "Filter": _f(4, 3, 3, 3)}, ["Output"],
     _conv(strides=(2, 2), paddings=(1, 1)), "Output", ["Input", "Filter"]),
    ("conv_nhwc_s2_pad", "conv2d",
     {"Input": _f(2, 9, 9, 3), "Filter": _f(4, 3, 3, 3)}, ["Output"],
     _conv("NHWC", strides=(2, 2), paddings=(1, 1)), "Output",
     ["Input", "Filter"]),
    ("conv_dilation_groups", "conv2d",
     {"Input": _f(2, 4, 10, 10), "Filter": _f(6, 2, 3, 3)}, ["Output"],
     _conv(paddings=(2, 1), dilations=(2, 2), groups=2), "Output",
     ["Input", "Filter"]),
    ("conv_nhwc_dilation_groups", "conv2d",
     {"Input": _f(2, 10, 10, 4), "Filter": _f(6, 2, 3, 3)}, ["Output"],
     _conv("NHWC", strides=(2, 1), paddings=(1, 2), dilations=(2, 1),
           groups=2), "Output", ["Input", "Filter"]),
    ("conv_four_paddings", "conv2d",
     {"Input": _f(1, 2, 7, 8), "Filter": _f(3, 2, 3, 2)}, ["Output"],
     _conv(strides=(2, 2), paddings=(1, 0, 2, 1)), "Output",
     ["Input", "Filter"]),
    ("conv_same_stride2", "conv2d",
     {"Input": _f(1, 2, 7, 8), "Filter": _f(3, 2, 3, 3)}, ["Output"],
     _conv(strides=(2, 2), padding_algorithm="SAME"), "Output",
     ["Input", "Filter"]),
    ("conv_1x1", "conv2d",
     {"Input": _f(2, 8, 5, 5), "Filter": _f(16, 8, 1, 1)}, ["Output"],
     _conv(), "Output", ["Input", "Filter"]),
    ("depthwise", "depthwise_conv2d",
     {"Input": _f(2, 4, 8, 8), "Filter": _f(4, 1, 3, 3)}, ["Output"],
     _conv(paddings=(1, 1)), "Output", ["Input", "Filter"]),
    ("pool_max_pad", "pool2d", {"X": _f(2, 3, 9, 9)}, ["Out"],
     _pool("max", (3, 3), (2, 2), (1, 1)), "Out", ["X"]),
    ("pool_max_ceil", "pool2d", {"X": _f(2, 3, 8, 8)}, ["Out"],
     _pool("max", (3, 3), (2, 2), ceil_mode=True), "Out", ["X"]),
    ("pool_max_pad_over_half", "pool2d", {"X": _f(1, 2, 5, 5)}, ["Out"],
     _pool("max", (2, 2), (2, 2), (1, 1)), "Out", ["X"]),
    ("pool_max_nhwc", "pool2d", {"X": _f(2, 9, 9, 3)}, ["Out"],
     _pool("max", (3, 3), (2, 2), (1, 1), fmt="NHWC"), "Out", ["X"]),
    ("pool_avg_exclusive_pad", "pool2d", {"X": _f(2, 3, 7, 7)}, ["Out"],
     _pool("avg", (3, 3), (2, 2), (1, 1)), "Out", ["X"]),
    ("pool_avg_inclusive_pad", "pool2d", {"X": _f(2, 3, 7, 7)}, ["Out"],
     _pool("avg", (3, 3), (2, 2), (1, 1), exclusive=False), "Out", ["X"]),
    ("pool_avg_ceil_exclusive", "pool2d", {"X": _f(2, 3, 8, 8)}, ["Out"],
     _pool("avg", (3, 3), (2, 2), (1, 1), ceil_mode=True), "Out", ["X"]),
    ("pool_avg_ceil_inclusive", "pool2d", {"X": _f(2, 3, 8, 8)}, ["Out"],
     _pool("avg", (3, 3), (2, 2), ceil_mode=True, exclusive=False), "Out",
     ["X"]),
    ("pool_avg_nhwc_pad", "pool2d", {"X": _f(2, 7, 7, 3)}, ["Out"],
     _pool("avg", (3, 3), (2, 2), (1, 1), fmt="NHWC"), "Out", ["X"]),
    ("pool_avg_7_resnet_head", "pool2d", {"X": _f(2, 8, 7, 7)}, ["Out"],
     _pool("avg", (7, 7)), "Out", ["X"]),
    ("pool_global_avg", "pool2d", {"X": _f(2, 3, 5, 6)}, ["Out"],
     _pool("avg", (2, 2), global_pooling=True), "Out", ["X"]),
    ("pool_global_max_nhwc", "pool2d", {"X": _f(2, 5, 6, 3)}, ["Out"],
     _pool("max", (2, 2), fmt="NHWC", global_pooling=True), "Out", ["X"]),
    # a window wholly in the padding: -inf in both packages
    ("pool_max_window_in_padding", "pool2d", {"X": _f(1, 2, 3, 3)},
     ["Out"], _pool("max", (2, 2), (1, 1), (2, 2)), None, []),
    ("bn_train_nchw", "batch_norm", _bn_inputs(_f(4, 3, 5, 5), 3), _BN_OUT,
     _bn(), "Y", ["X", "Scale", "Bias"]),
    ("bn_train_nhwc", "batch_norm", _bn_inputs(_f(4, 5, 5, 3), 3), _BN_OUT,
     _bn(layout="NHWC"), "Y", ["X", "Scale", "Bias"]),
    ("bn_train_2d", "batch_norm", _bn_inputs(_f(8, 6), 6), _BN_OUT, _bn(),
     "Y", ["X", "Scale", "Bias"]),
    ("bn_test_nchw", "batch_norm", _bn_inputs(_f(4, 3, 5, 5), 3), _BN_OUT,
     _bn(is_test=True), "Y", ["X", "Scale", "Bias"]),
    ("bn_test_nhwc", "batch_norm", _bn_inputs(_f(4, 5, 5, 3), 3), _BN_OUT,
     _bn(is_test=True, layout="NHWC"), "Y", ["X", "Scale", "Bias"]),
    ("bn_test_2d", "batch_norm", _bn_inputs(_f(8, 6), 6), _BN_OUT,
     _bn(is_test=True), "Y", ["X", "Scale", "Bias"]),
    ("bn_global_stats", "batch_norm", _bn_inputs(_f(4, 3, 5, 5), 3),
     _BN_OUT, _bn(use_global_stats=True), "Y", ["X", "Scale", "Bias"]),
    ("relu", "relu", {"X": _f(3, 7)}, ["Out"], {}, "Out", ["X"]),
    ("top_k", "top_k", {"X": _SCORES}, ["Out", "Indices"], {"k": 3}, "Out",
     ["X"]),
    ("accuracy", "accuracy",
     {"Out": np.sort(_SCORES, 1)[:, ::-1][:, :3].copy(), "Indices": _TOPI,
      "Label": np.array([[_TOPI[0, 0]], [_TOPI[1, 2]], [0], [_TOPI[3, 1]],
                         [9], [_TOPI[5, 0]]], np.int64)},
     ["Accuracy", "Correct", "Total"], {}, None, []),
    ("momentum", "momentum",
     {"Param": _f(4, 5), "Grad": _f(4, 5), "Velocity": _f(4, 5) * 0.1,
      "LearningRate": np.array([0.1], np.float32)},
     ["ParamOut", "VelocityOut"], {"mu": 0.9, "use_nesterov": False}, None,
     []),
    ("momentum_nesterov", "momentum",
     {"Param": _f(4, 5), "Grad": _f(4, 5), "Velocity": _f(4, 5) * 0.1,
      "LearningRate": np.array([0.05], np.float32)},
     ["ParamOut", "VelocityOut"], {"mu": 0.9, "use_nesterov": True}, None,
     []),
]


def _ids(cases):
    return [c[0] for c in cases]


@pytest.mark.parametrize("case", _CASES, ids=_ids(_CASES))
def test_op_matches_jax(case):
    """Forward outputs and the shapes and dtypes each package declares at
    build time."""
    _, op_type, inputs, outputs, attrs, _, _ = case
    (jvals, jdecl), (tvals, tdecl) = _both(op_type, inputs, outputs, attrs)
    for n in jvals:
        assert tdecl[n][0] == jdecl[n][0], n
        assert _int32(tdecl[n][1]) == _int32(jdecl[n][1]), n
        assert tvals[n].shape == jvals[n].shape, n
        np.testing.assert_allclose(tvals[n], jvals[n], atol=TOL, rtol=TOL,
                                   err_msg=n)


_GRAD_CASES = [c for c in _CASES if c[5] is not None]


@pytest.mark.parametrize("case", _GRAD_CASES, ids=_ids(_GRAD_CASES))
def test_op_grad_matches_jax(case):
    """The generic vjp on both sides: the same grad-op descs, input
    gradients within op_test's 5e-3."""
    _, op_type, inputs, outputs, attrs, target, wrt = case
    jg, jdesc = _run_grad(pt, executor(pt), op_type, inputs, outputs,
                          attrs, target, wrt)
    tg, tdesc = _run_grad(ptt, ptt.Executor(ptt.CPUPlace()), op_type,
                          inputs, outputs, attrs, target, wrt)
    assert tdesc == jdesc
    assert len(tg) == len(jg) > 0
    for t, j in zip(tg, jg):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, atol=GRAD_TOL, rtol=GRAD_TOL)


def _run_bn_bf16(pkg, exe, ins, attrs):
    """batch_norm on ins["X"] cast to bf16 (the AMP rewrite's pattern:
    Scale, Bias and the running statistics stay f32), then gradients back
    to the f32 X, Scale and Bias. Returns (outputs, grads, declared
    dtypes)."""
    main = pkg.Program()
    blk = main.global_block
    x = ins["X"]
    feed = {}
    for slot, arr in ins.items():
        blk.create_var(name=slot, shape=arr.shape, dtype="float32")
        feed[slot] = arr
    blk.create_var(name="X16", shape=x.shape, dtype="bfloat16")
    blk.append_op("cast", {"X": ["X"]}, {"Out": ["X16"]},
                  {"out_dtype": "bfloat16"})
    bn_in = {s: [s] for s in ins}
    bn_in["X"] = ["X16"]
    blk.append_op("batch_norm", bn_in, {s: [s + "_out"] for s in _BN_OUT},
                  attrs)
    y = blk.var("Y_out")
    feed["dout"] = np.random.RandomState(5).randn(*y.shape) \
        .astype(np.float32)
    blk.create_var(name="dout", shape=y.shape, dtype="float32")
    blk.create_var(name="dout16", shape=y.shape, dtype="bfloat16")
    blk.append_op("cast", {"X": ["dout"]}, {"Out": ["dout16"]},
                  {"out_dtype": "bfloat16"})
    grads = pkg.gradients([y], [blk.var(n) for n in ("X", "Scale", "Bias")],
                          target_gradients=[blk.var("dout16")])
    names = [s + "_out" for s in _BN_OUT]
    vals = exe.run(main, feed=feed, fetch_list=names + [g.name
                                                        for g in grads])
    vals = [np.asarray(v, np.float32) for v in vals]
    return (vals[:len(names)], vals[len(names):],
            [blk.var(n).dtype for n in names])


@pytest.mark.parametrize("layout,shape", [("NCHW", (4, 3, 5, 5)),
                                          ("NHWC", (4, 5, 5, 3)),
                                          ("NCHW", (8, 6))],
                         ids=["nchw", "nhwc", "2d"])
@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
def test_batch_norm_bf16_matches_jax(layout, shape, is_test):
    """bf16 X, f32 Scale, Bias and running statistics. Y is bf16 in both
    packages and within 1e-5 + one bf16 ulp relative (both compute in f32
    and round once); the f32 statistics within 1e-5. The X gradient is bf16
    in both, within 1e-5 + one ulp relative of max |dX| per element: its
    replayed mean terms are sums over the batch, which XLA takes in bf16
    and torch in f32. The Scale and Bias gradients (f32 sums of bf16
    products) within op_test's 5e-3 relative to their largest value."""
    c = shape[1] if layout == "NCHW" else shape[-1]
    ins = _bn_inputs(_f(*shape) * 2 + 1, c)
    attrs = _bn(is_test=is_test, layout=layout)
    jv, jg, jdt = _run_bn_bf16(pt, executor(pt), ins, attrs)
    tv, tg, tdt = _run_bn_bf16(ptt, ptt.Executor(ptt.CPUPlace()), ins,
                               attrs)
    assert tdt == jdt and tdt[0] == "bfloat16"
    np.testing.assert_allclose(tv[0], jv[0], atol=TOL, rtol=BF16_ULP)
    for a, b in zip(tv[1:], jv[1:]):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    dx_tol = TOL + BF16_ULP * np.abs(jg[0]).max()
    assert np.abs(tg[0] - jg[0]).max() <= dx_tol
    for a, b in zip(tg[1:], jg[1:]):
        assert np.abs(a - b).max() <= GRAD_TOL * np.abs(b).max()


def test_unported_branches_raise():
    """Adaptive pooling no longer raises: pool2d(adaptive=True) routes to
    adaptive_pool2d as in JAX (ragged bins here; every case in
    tests/test_torch_core_ops.py); arch="vgg16" builds since
    models/vgg.py was ported (tests/test_torch_book.py holds its forward
    to JAX's), and an unknown arch raises ValueError as in JAX."""
    x = _f(1, 2, 4, 4)
    attrs = dict(_pool("avg", (2, 3)), adaptive=True)
    (jvals, _), (tvals, _) = _both("pool2d", {"X": x}, ["Out"], attrs)
    np.testing.assert_allclose(tvals["Out_out"], jvals["Out_out"],
                               atol=TOL, rtol=TOL)
    with ptt.unique_name_guard(), ptt.program_guard(ptt.Program(),
                                                    ptt.Program()):
        f = tresnet.image_classification_program("vgg16")
        assert f["logits"].shape == (-1, 10)
        with pytest.raises(ValueError):
            tresnet.image_classification_program("alexnet")


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

def _resnet50_program(pkg, resnet, amp):
    """bench_resnet50's program: 224x224, 1000 classes, NCHW, Momentum(0.1,
    0.9), with the bf16 AMP decorate when `amp`."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data("img", [3, 224, 224], dtype="float32")
        label = pkg.layers.data("label", [1], dtype="int64")
        logits = resnet.resnet50(img, 1000)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, label))
        opt = pkg.optimizer.MomentumOptimizer(0.1, 0.9)
        if amp:
            opt = pkg.contrib.mixed_precision.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


# the JAX package's ResNet-50 train programs, built once for the module
_JAX_RESNET50 = {}


def _jax_resnet50(amp):
    if amp not in _JAX_RESNET50:
        _JAX_RESNET50[amp] = _resnet50_program(pt, jresnet, amp)
    return _JAX_RESNET50[amp]


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_resnet50_train_program_matches_jax(amp):
    """The port's bench_resnet50 program against the program the JAX
    package's tools/bench_resnet50.py builds."""
    jmain, jstart, _ = _jax_resnet50(amp)
    tmain, tstart, _, _ = bench.build_program(amp=amp)
    types = [op.type for op in tmain.global_block.ops]
    assert types == [op.type for op in jmain.global_block.ops]
    assert len(types) == (643 if amp else 532)
    assert types.count("conv2d") == 53 and types.count("momentum") == 161
    want = {"conv2d_grad", "batch_norm_grad", "pool2d_grad", "relu_grad"}
    if amp:
        want |= {"cast", "cast_grad"}
    assert want <= set(types)
    assert _program_dict(tmain) == _program_dict(jmain)
    assert _program_dict(tstart) == _program_dict(jstart)


def _carry(jmain, jstart, extra=()):
    """Run the JAX startup program; its values, and a port scope holding
    them."""
    jscope = pt.Scope()
    jexe = executor(pt)
    jexe.run(jstart, scope=jscope)
    init = {v.name: np.asarray(jscope.find_var(v.name))
            for v in jmain.list_vars()
            if v.persistable and jscope.find_var(v.name) is not None}
    tscope = ptt.Scope()
    ptt.io.set_params_from_numpy(tscope, init, "cpu")
    return jexe, jscope, tscope, init


def _value(scope, n):
    if isinstance(scope, pt.Scope):
        return np.asarray(scope.find_var(n), np.float32)
    return scope.get_numpy(n).astype(np.float32)


def _image_feed(step, batch, hw, classes):
    r = np.random.RandomState(70 + step)
    return {"img": r.rand(batch, 3, hw, hw).astype(np.float32),
            "label": r.randint(0, classes, (batch, 1)).astype(np.int64)}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_cifar_resnet20_momentum_steps_match_jax():
    """image_classification_program("resnet_cifar10"): ResNet-20 on 32x32,
    batch 4, Momentum(1e-3, 0.9), fp32, 3 steps from the JAX startup
    values. Held: losses within 1e-5 relative (measured 1.6e-7), accuracy
    equal, BN running statistics within 1e-5 of their largest value
    (measured 1.1e-6), parameters within 2e-5 (measured 3.2e-6; 3 steps
    move them by up to ~1e-2) and velocities, per tensor, within 1e-2
    relative L2 (measured 1.4e-3).

    The velocities are the looser check because a gradient of a ReLU net
    with batch-norm at small batch moves with the sign of every
    pre-activation that lies within rounding of 0: at lr 1e-2 the two
    trajectories' step-3 gradients part by 16 % relative L2, and at
    ResNet-50 depth a 1e-7 relative change of the input moves the port's
    own gradients by 2.7 % (`test_resnet50_step_matches_jax`)."""
    progs = {}
    for name, pkg, mod in (("jax", pt, jresnet), ("torch", ptt, tresnet)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name_guard(), pkg.program_guard(main, startup):
            f = mod.image_classification_program("resnet_cifar10")
            pkg.optimizer.MomentumOptimizer(1e-3, 0.9).minimize(f["loss"])
        progs[name] = (main, startup, f)
    jmain, jstart, jf = progs["jax"]
    tmain, _, tf = progs["torch"]
    assert _program_dict(tmain) == _program_dict(jmain)
    jexe, jscope, tscope, init = _carry(jmain, jstart)
    texe = ptt.Executor(ptt.CPUPlace())
    for i in range(3):
        feed = _image_feed(i, 4, 32, 10)
        jl, ja = jexe.run(jmain, feed=feed,
                          fetch_list=[jf["loss"], jf["acc"]], scope=jscope)
        tl, ta = texe.run(tmain, feed=feed,
                          fetch_list=[tf["loss"], tf["acc"]], scope=tscope)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_array_equal(ta, ja)
    params = {p.name for p in jmain.global_block.all_parameters()
              if p.trainable}
    kinds = {"stats": 0, "velocity": 0, "param": 0}
    for v in jmain.list_vars():
        n = v.name
        if not v.persistable or n not in init or v.dtype != "float32":
            continue
        want, got = _value(jscope, n), _value(tscope, n)
        if "velocity" in n:
            kinds["velocity"] += 1
            assert _rel_l2(got, want) <= 1e-2, n
        elif n in params:
            kinds["param"] += 1
            assert np.abs(got - want).max() <= 2e-5, n
        elif ".mean_" in n or ".variance_" in n:
            kinds["stats"] += 1
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), n
    assert kinds == {"stats": 2 * 21, "velocity": 65, "param": 65}


def _params_and_grads(exe, main, loss, scope, feed):
    params = [p.name for p in main.global_block.all_parameters()
              if p.trainable]
    res = exe.run(main, feed=feed,
                  fetch_list=[loss] + [p + "@GRAD" for p in params],
                  scope=scope)
    return float(np.ravel(res[0])[0]), dict(
        zip(params, (np.asarray(g, np.float32) for g in res[1:])))


def test_resnet50_step_matches_jax():
    """Full ResNet-50 (224x224, 1000 classes), batch 2, fp32, one step from
    the JAX startup values: the loss within 1e-5 relative (measured
    2.4e-6) and each of the 161 gradients within 0.1 relative L2 of JAX's
    (measured worst 0.029, batch_norm_1.w_0).

    No tighter bound holds for any two correct implementations: a ReLU
    net's gradient flips with the sign of each pre-activation within
    rounding of 0, and batch-norm at batch 2 spreads each flip over a
    whole channel. Measured: multiplying the input by 1 + 1e-7 moves the
    port's own gradients by up to 0.027 relative L2 (0.27 of max |g|
    element-wise, conv2d_48.w_0), as far as they lie from JAX's."""
    jmain, jstart, jloss = _jax_resnet50(False)
    tmain, _, tloss = _resnet50_program(ptt, tresnet, False)
    jexe, jscope, tscope, _ = _carry(jmain, jstart)
    feed = _image_feed(0, 2, 224, 1000)
    jl, jg = _params_and_grads(jexe, jmain, jloss, jscope, feed)
    tl, tg = _params_and_grads(ptt.Executor(ptt.CPUPlace()), tmain, tloss,
                               tscope, feed)
    assert len(tg) == len(jg) == 161
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for n, g in jg.items():
        assert _rel_l2(tg[n], g) <= 0.1, n


def _narrow_program(pkg, mod, amp):
    """A narrow bottleneck stack on 32x32 inputs: the ResNet-50 stem (7x7
    conv, BN, ReLU, 3x3 max pool), two bottleneck stages (the second with
    stride 2 and a projection shortcut), global average pool, fc."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data("img", [3, 32, 32], dtype="float32")
        label = pkg.layers.data("label", [1], dtype="int64")
        x = mod.conv_bn_layer(img, 16, 7, 2, 3)
        x = pkg.layers.pool2d(x, 3, "max", 2, pool_padding=1)
        x = mod._layer_stack(mod.bottleneck, x, 16, 8, 2, 1)
        x = mod._layer_stack(mod.bottleneck, x, 32, 16, 1, 2)
        x = pkg.layers.pool2d(x, 1, "avg", global_pooling=True)
        logits = pkg.layers.fc(x, 10)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, label))
        opt = pkg.optimizer.MomentumOptimizer(0.01, 0.9)
        if amp:
            opt = pkg.contrib.mixed_precision.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def test_bottleneck_stack_fp32_grads_match_jax():
    """The narrow stack in fp32, batch 8, where no pre-activation lies
    within rounding of 0: every gradient within 1e-4 * max |g| + 1e-7 of
    JAX's (measured 3.0e-6 * max |g|, batch_norm_9.w_0)."""
    jmain, jstart, jloss = _narrow_program(pt, jresnet, False)
    tmain, _, tloss = _narrow_program(ptt, tresnet, False)
    jexe, jscope, tscope, _ = _carry(jmain, jstart)
    feed = _image_feed(1, 8, 32, 10)
    jl, jg = _params_and_grads(jexe, jmain, jloss, jscope, feed)
    tl, tg = _params_and_grads(ptt.Executor(ptt.CPUPlace()), tmain, tloss,
                               tscope, feed)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(tg) == set(jg)
    for n, g in jg.items():
        assert np.abs(tg[n] - g).max() <= 1e-4 * np.abs(g).max() + 1e-7, n


def test_amp_bottleneck_grads_match_jax_fp32():
    """bf16 AMP on the narrow stack, batch 8: the port's AMP program equals
    JAX's op for op, and it is held against the exact gradients, JAX's
    fp32 ones from the same values, as the BERT test holds its AMP run:
    the loss within 1e-2 relative (measured 1.4e-3), each gradient within
    1.0 relative L2 and their mean over the 38 tensors within 0.35
    (measured worst 0.48, batch_norm_1.b_0, and mean 0.22; JAX's own AMP
    program lies 0.29 and 0.16 from its fp32 one).

    Why so loose: bf16 rounding moves values by up to 2^-9, and this ReLU
    net's gradient at initialisation is that sensitive to its input.
    Measured in fp32 on the port: scaling each input value by 1 + 2e-3 *
    N(0, 1) moves the gradients by 0.29 worst and 0.17 mean relative L2.
    A wrong cast or a dropped gradient is off by 1 or more."""
    jmain, jstart, jloss = _narrow_program(pt, jresnet, False)
    jamp, _, _ = _narrow_program(pt, jresnet, True)
    tmain, _, tloss = _narrow_program(ptt, tresnet, True)
    assert _program_dict(tmain) == _program_dict(jamp)
    assert "cast" in {op.type for op in tmain.global_block.ops}
    jexe, jscope, tscope, _ = _carry(jmain, jstart)
    feed = _image_feed(1, 8, 32, 10)
    jl, jg = _params_and_grads(jexe, jmain, jloss, jscope, feed)
    tl, tg = _params_and_grads(ptt.Executor(ptt.CPUPlace()), tmain, tloss,
                               tscope, feed)
    assert np.isfinite(tl) and abs(tl - jl) <= 1e-2 * abs(jl)
    assert set(tg) == set(jg) and len(jg) == 38
    gaps = {n: _rel_l2(tg[n], g) for n, g in jg.items()}
    assert max(gaps.values()) <= 1.0, gaps
    assert np.mean(list(gaps.values())) <= 0.35, gaps


def test_bench_feed_and_no_card(monkeypatch):
    """bench_resnet50's feed has the JAX tool's shapes and types, and the
    bench needs a card: without one it exits non-zero before building."""
    f = bench.feed(np.random.RandomState(0), 3)
    assert f["img"].shape == (3, 3, 224, 224) and f["img"].dtype == np.float32
    assert f["label"].shape == (3, 1) and f["label"].dtype == np.int64
    assert bench.feed(np.random.RandomState(0), 2, "NHWC")["img"].shape == \
        (2, 224, 224, 3)
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code != 0


def test_served_clone_matches_jax(tmp_path):
    """Serving on the CPU: clone(for_test=True) of the narrow stack's train
    program (batch_norm on the running statistics), saved with
    save_inference_model from the port and run through its Predictor,
    against JAX's executor on its own test clone with the same values:
    logits within 1e-5 + 1e-5 relative."""
    jmain, jstart, _ = _narrow_program(pt, jresnet, False)
    tmain, _, _ = _narrow_program(ptt, tresnet, False)
    jtest, ttest = jmain.clone(for_test=True), tmain.clone(for_test=True)
    assert {op.attrs["is_test"] for op in ttest.global_block.ops
            if op.type == "batch_norm"} == {True}
    jexe, jscope, tscope, _ = _carry(jmain, jstart)
    # move the running statistics off their initial 0 and 1
    for n in list(tscope.var_names()):
        if ".mean_" in n or ".variance_" in n:
            v = np.asarray(jscope.find_var(n)) + 0.25
            jscope.set_var(n, v)
            ptt.io.set_params_from_numpy(tscope, {n: v}, "cpu")
    name = [op for op in tmain.global_block.ops
            if op.type == "elementwise_add"][-1].output("Out")[0]
    ptt.io.save_inference_model(str(tmp_path), ["img"],
                                [ttest.global_block.var(name)],
                                ptt.Executor(ptt.CPUPlace()),
                                main_program=ttest, scope=tscope)
    cfg = ptt.inference.Config(str(tmp_path))
    cfg.disable_gpu()
    img = np.random.RandomState(9).rand(4, 3, 32, 32).astype(np.float32)
    got, = ptt.inference.create_predictor(cfg).run({"img": img})
    want, = jexe.run(jtest, feed={"img": img,
                                  "label": np.zeros((4, 1), np.int64)},
                     fetch_list=[name], scope=jscope)
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
