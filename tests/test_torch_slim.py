"""The pass framework, the builtin passes, the whole of `contrib/slim`
(quantization, pruning, distillation, light-NAS) and the contrib program
statistics of the PyTorch port against the JAX package, on the CPU.

  * the four builtin passes, a user-defined pattern pass and the matcher
    on the programs of tests/test_pass_framework.py: equal programs op
    for op in both packages, and the same outputs;
  * the ResNet-50 QAT program of `paddle_tpu_torch/tools/slim_cases.py`
    at the full [3, 4, 6, 3] layout, fused and quantized, built in both
    packages, not run: main, test and startup equal, 16 fused ops;
  * tests/test_slim.py's 8x8 conv net under QAT, both activation and
    weight settings, two Adam steps, each package from its own state after
    one carry of the JAX state: after each step the loss within 1e-5
    relative, the weight gradients within op_test's 5e-3, the moving
    scales within 1e-6 and every updated parameter, Adam moment and
    written-back scale within 1e-5; the freeze pass, from the JAX state
    carried again, gives the same program, the same snapped weights and
    scales, and logits within 1e-5;
  * post-training quantization, abs_max and KL: thresholds within 1e-6
    relative, the same weight scales and quantized program;
  * the pruners' masks equal; the distillation losses within 1e-5; the SA
    controller's tokens, flops, latency_estimate and a searcher's history
    equal for a seed; the loopback controller protocol across packages;
  * `summary`, `memory_usage` and `op_freq_statistic` equal on a program.

Every program is built under a unique-name guard in each package, and
each run starts from the port's startup values carried to both scopes
(`_start_both`).
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.contrib import slim as jslim
from paddle_tpu_torch.contrib import slim as tslim
from paddle_tpu_torch.tools.slim_cases import (NUM_BOTTLENECKS,
                                               slim_resnet50_programs)
from test_torch_core_layers import _build, _start_both
from test_torch_gpt_inference import _program_dict
from torch_port_common import executor, one_torch_thread  # noqa: F401

OUT_TOL = 1e-5
GRAD_TOL = 5e-3
PKGS = (pt, ptt)


def _op_test_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = max(np.abs(a).max(initial=0), np.abs(b).max(initial=0), 1e-3)
    return np.abs(a - b).max(initial=0) / den


def _run_both(jm, tm, fetch, feed, jscope, tscope):
    j = executor(pt).run(jm, feed=feed, fetch_list=fetch, scope=jscope)
    t = executor(ptt).run(tm, feed=feed, fetch_list=fetch, scope=tscope)
    return [np.asarray(v) for v in j], [np.asarray(v) for v in t]


def _carry(jscope, tscope, names):
    """The JAX scope's values of `names` into the port's scope."""
    ptt.io.set_params_from_numpy(
        tscope, {n: np.asarray(jscope.find_var(n)) for n in names}, "cpu")


# ---------------------------------------------------------------------------
# the pass framework and the builtin passes
# ---------------------------------------------------------------------------

def _add_relu(pkg):
    x = pkg.layers.data("x", [4])
    y = pkg.layers.data("y", [4])
    return pkg.layers.relu(pkg.layers.elementwise_add(x, y))


def _add_relu_shared(pkg):
    z = pkg.layers.elementwise_add(pkg.layers.data("x", [4]),
                                   pkg.layers.data("y", [4]))
    return pkg.layers.relu(z), pkg.layers.scale(z, scale=2.0)


def _fc(pkg):
    return pkg.layers.fc(pkg.layers.data("x", [4]), 3)


def _apply(name, **kw):
    def run(pkg, main, startup):
        pkg.framework.apply_pass(name, main, **kw)
    return run


def _quant_transform(pkg, main, startup):
    pkg.framework.apply_pass("quant_transform", main, startup=startup)


@pytest.mark.parametrize("build,apply,fused", [
    (_add_relu, _apply("fuse_elewise_add_act"), 1),
    (_add_relu_shared, _apply("fuse_elewise_add_act"), 0),
    (_fc, _apply("amp_bf16_rewrite"), 0),
    (_fc, _quant_transform, 0),
], ids=["fuse", "fuse_shared_intermediate", "amp_bf16", "quant_transform"])
def test_builtin_passes_match_jax(build, apply, fused):
    progs = []
    for pkg in PKGS:
        main, startup, _ = _build(pkg, build)
        with pkg.unique_name_guard():
            apply(pkg, main, startup)
        progs.append((main, startup))
    (jm, js), (tm, ts) = progs
    assert _program_dict(jm) == _program_dict(tm)
    assert _program_dict(js) == _program_dict(ts)
    types = [op.type for op in tm.global_block.ops]
    assert types.count("fused_elemwise_activation") == fused
    if build is _add_relu:
        rng = np.random.RandomState(0)
        feed = {"x": rng.randn(2, 4).astype("f"),
                "y": rng.randn(2, 4).astype("f")}
        out = tm.global_block.ops[-1].output("Out")[0]
        jscope, tscope, _ = _start_both(ts)
        j, t = _run_both(jm, tm, [out], feed, jscope, tscope)
        np.testing.assert_allclose(t[0], j[0], rtol=OUT_TOL, atol=OUT_TOL)
        np.testing.assert_array_equal(
            t[0], np.maximum(feed["x"] + feed["y"], 0))


def test_user_pattern_pass_and_matcher_match_jax():
    """A user fuse pass, scale(scale(x)) -> one scale, written against
    each package's public API, and the matcher's two matches."""
    def double_scale(pkg):
        return pkg.layers.relu(pkg.layers.scale(pkg.layers.relu(
            pkg.layers.scale(pkg.layers.scale(pkg.layers.data("x", [3]),
                                              scale=2.0), scale=5.0)),
            scale=3.0))

    progs = []
    for i, pkg in enumerate(PKGS):
        fw = pkg.framework

        class FoldDoubleScale(fw.PatternPass):
            def build_pattern(self, p):
                s1 = p.op("scale")
                p.op("scale", inputs={"X": s1.out("Out")})

            def rewrite(self, block, match):
                s1, s2 = match.ops
                k = s1.attrs.get("scale", 1.0) * s2.attrs.get("scale", 1.0)
                fw.replace_ops(block, [s1, s2], [{
                    "type": "scale", "inputs": {"X": s1.inputs["X"]},
                    "outputs": {"Out": s2.outputs["Out"]},
                    "attrs": {"scale": k, "bias": 0.0}}])

        name = f"test_torch_slim_fold_double_scale_{i}"
        if not fw.PassRegistry.has(name):
            fw.register_pass(name)(FoldDoubleScale)
        main, startup, _ = _build(pkg, double_scale)
        p = fw.Pattern()
        s = p.op("scale")
        p.op("relu", inputs={"X": s.out("Out")})
        assert len(fw.find_matches(main.global_block, p)) == 2
        n = len(main.global_block.ops)
        fw.apply_pass(name, main)
        assert len(main.global_block.ops) == n - 1
        with pytest.raises(KeyError):
            fw.apply_pass("no_such_pass", pkg.Program())
        progs.append(main)
    assert _program_dict(progs[0]) == _program_dict(progs[1])


# ---------------------------------------------------------------------------
# ResNet-50 QAT, built only
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resnet50_qat():
    return [slim_resnet50_programs(pkg) for pkg in PKGS]


def test_resnet50_qat_programs_equal(resnet50_qat):
    jp, tp = resnet50_qat
    for k in ("main", "test", "startup"):
        assert _program_dict(jp[k]) == _program_dict(tp[k]), k
    assert jp["states"] == tp["states"] and len(tp["states"]) == 50
    types = [op.type for op in tp["main"].global_block.ops]
    assert types.count("fused_elemwise_activation") == NUM_BOTTLENECKS
    assert types.count("fused_elemwise_activation_grad") == NUM_BOTTLENECKS
    assert "relu_grad" in types
    # 53 conv filters and the fc weight channel-wise, 50 activations
    assert types.count(
        "fake_channel_wise_quantize_dequantize_abs_max") == 54
    assert types.count(
        "fake_quantize_dequantize_moving_average_abs_max") == 50
    test_types = [op.type for op in tp["test"].global_block.ops]
    assert test_types.count("fused_elemwise_activation") == NUM_BOTTLENECKS
    assert all(op.attrs.get("is_test") for op in tp["test"].global_block.ops
               if op.type.startswith("fake_quantize_dequantize_moving"))


# ---------------------------------------------------------------------------
# the narrow QAT net
# ---------------------------------------------------------------------------

def _conv_net(pkg):
    L = pkg.layers
    img = L.data("img", [1, 8, 8])
    label = L.data("label", [1], dtype="int64")
    h = L.conv2d(img, 4, 3, padding=1, act="relu")
    h = L.pool2d(h, 2, "max", 2)
    logits = L.fc(h, size=3)
    return L.mean(L.softmax_with_cross_entropy(logits, label)), logits


def _feed(rng, b=8):
    return {"img": rng.randn(b, 1, 8, 8).astype(np.float32),
            "label": rng.randint(0, 3, (b, 1)).astype(np.int64)}


def _qat(pkg, act_type, w_type):
    slim = jslim if pkg is pt else tslim
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        loss, logits = _conv_net(pkg)
        slim.QuantizationTransformPass(
            activation_quantize_type=act_type,
            weight_quantize_type=w_type).apply(main, startup)
        test = main.clone(for_test=True)
        pkg.optimizer.Adam(learning_rate=0.02).minimize(loss)
    return main, test, startup, loss, logits


@pytest.mark.parametrize("act_type,w_type", [
    ("moving_average_abs_max", "channel_wise_abs_max"),
    ("abs_max", "abs_max"),
])
def test_narrow_qat_trains_and_freezes_as_jax(act_type, w_type):
    (jm, jt, js, _, _), (tm, tt, ts, loss, logits) = [
        _qat(pkg, act_type, w_type) for pkg in PKGS]
    for a, b in ((jm, tm), (jt, tt), (js, ts)):
        assert _program_dict(a) == _program_dict(b)
    fakes = [op for op in tm.global_block.ops if op.type.startswith("fake_")
             and not op.type.endswith("_grad")]
    assert len(fakes) == 4
    jscope, tscope, init = _start_both(ts)
    weights = ["conv2d_0.w_0", "fc_0.w_0"]
    assert set(weights) <= set(init)
    states = [n for n in init if ".quant_state" in n]
    assert len(states) == (2 if act_type.startswith("moving") else 0)
    fetch = [loss.name] + [w + "@GRAD" for w in weights] + states
    rng = np.random.RandomState(0)
    # one carry, then each package steps from its own state
    _carry(jscope, tscope, list(init))
    for step in range(2):
        feed = _feed(rng)
        j, t = _run_both(jm, tm, fetch, feed, jscope, tscope)
        assert np.isfinite(t[0]).all()
        assert abs(t[0].item() - j[0].item()) <= OUT_TOL * abs(j[0].item())
        for name, a, b in zip(fetch[1:3], t[1:3], j[1:3]):
            assert np.abs(a).max() > 0, name
            assert _op_test_rel(a, b) <= GRAD_TOL, (step, name)
        for name, a, b in zip(states, t[3:], j[3:]):
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
            assert float(a) > 0
        # the Adam updates and the moving scales written back
        for name in init:
            np.testing.assert_allclose(
                tscope.find_var(name).numpy(),
                np.asarray(jscope.find_var(name)), rtol=OUT_TOL,
                atol=OUT_TOL, err_msg=f"step {step}: {name}")

    # freeze from the same state: the same program, weights and scales
    _carry(jscope, tscope, list(init))
    x = _feed(rng, 4)
    (ref,), _ = _run_both(jt, tt, [logits.name], x, jscope, tscope)
    frozen = []
    for pkg, prog, scope in ((pt, jt, jscope), (ptt, tt, tscope)):
        slim = jslim if pkg is pt else tslim
        infer = prog.clone(for_test=True)
        frozen.append((infer, slim.QuantizationFreezePass().apply(
            infer, scope)))
    (ji, jsc), (ti, tsc) = frozen
    assert _program_dict(ji) == _program_dict(ti)
    assert sorted(jsc) == sorted(tsc) == weights
    for w in weights:
        np.testing.assert_array_equal(tsc[w], jsc[w])
        np.testing.assert_array_equal(tscope.find_var(w).numpy(),
                                      np.asarray(jscope.find_var(w)))
    j, t = _run_both(ji, ti, [logits.name], x, jscope, tscope)
    np.testing.assert_allclose(t[0], j[0], rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(t[0], ref, rtol=1e-2, atol=1e-2)


def test_qat_pass_requires_pre_backward_in_both():
    for pkg, slim in ((pt, jslim), (ptt, tslim)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name_guard(), pkg.program_guard(main, startup):
            loss, _ = _conv_net(pkg)
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
            with pytest.raises(RuntimeError, match="before"):
                slim.QuantizationTransformPass().apply(main, startup)


@pytest.mark.parametrize("algo", ["abs_max", "KL"])
def test_post_training_quantization_matches_jax(algo):
    built = [_build(pkg, _conv_net) for pkg in PKGS]
    (jm, js, (_, jlogits)), (tm, ts, (_, logits)) = built
    jscope, tscope, init = _start_both(ts)
    rng = np.random.RandomState(5)
    feeds = [_feed(rng, 16) for _ in range(2)]
    res = []
    for pkg, slim, main, lg, scope in ((pt, jslim, jm, jlogits, jscope),
                                       (ptt, tslim, tm, logits, tscope)):
        ptq = slim.PostTrainingQuantization(
            executor(pkg), main, ["img"], [lg], scope=scope, algo=algo)
        with pkg.unique_name_guard():
            res.append(ptq.quantize(feeds))
    jq, tq = res
    assert _program_dict(jq) == _program_dict(tq)
    assert sum(op.type == "quantize" for op in tq.global_block.ops) == 2
    ja, ta = jq._quant_act_thresholds, tq._quant_act_thresholds
    assert sorted(ja) == sorted(ta) and len(ta) == 2
    for n in ta:
        assert abs(ta[n] - ja[n]) <= 1e-6 * abs(ja[n]), (n, ta[n], ja[n])
    for n in tq._quant_weight_scales:
        np.testing.assert_array_equal(tq._quant_weight_scales[n],
                                      jq._quant_weight_scales[n])
    j, t = _run_both(jq, tq, [logits.name], feeds[0], jscope, tscope)
    assert np.isfinite(t[0]).all()
    np.testing.assert_allclose(t[0], j[0], rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# pruning and distillation
# ---------------------------------------------------------------------------

def test_pruners_match_jax():
    (jm, _, _), (tm, ts, _) = [_build(pkg, _conv_net) for pkg in PKGS]
    jscope, tscope, init = _start_both(ts)
    got = []
    for slim, main, scope in ((jslim, jm, jscope), (tslim, tm, tscope)):
        masks = slim.Pruner("l1_norm").prune(
            main, scope, ["conv2d_0.w_0", "fc_0.w_0"], [0.5, 0.25])
        masks.update(slim.Pruner("abs").prune(main, scope, ["fc_0.b_0"],
                                              [0.34]))
        scope.set_var("conv2d_0.w_0", scope.find_var("conv2d_0.w_0") + 1)
        slim.apply_masks(scope, masks)

        def eval_fn(_scope=scope):
            # a loss that leans on the fc weight only
            return float(np.abs(np.asarray(_scope.find_var("fc_0.w_0")))
                         .sum())

        sp = slim.prune.SensitivePruner()
        smasks, alloc = sp.prune(main, scope, ["fc_0.w_0", "conv2d_0.b_0"],
                                 eval_fn, target_ratio=0.3)
        got.append((masks, smasks, alloc,
                    {n: np.asarray(scope.find_var(n)) for n in init}))
    (jmk, jsm, jal, jv), (tmk, tsm, tal, tv) = got
    assert jal == tal
    for a, b in ((jmk, tmk), (jsm, tsm)):
        assert sorted(a) == sorted(b)
        for n in a:
            np.testing.assert_array_equal(a[n], b[n], err_msg=n)
    assert (~tmk["conv2d_0.w_0"]).all(axis=(1, 2, 3)).sum() == 2
    for n in init:
        np.testing.assert_array_equal(tv[n], jv[n], err_msg=n)


def _teacher(pkg):
    x = pkg.layers.data("img", [1, 8, 8])
    f = pkg.layers.conv2d(x, 3, 3, padding=1, act="relu",
                          param_attr=pkg.ParamAttr(name="tconv"))
    g = pkg.layers.conv2d(f, 2, 3, padding=1,
                          param_attr=pkg.ParamAttr(name="tconv2"))
    return pkg.layers.fc(g, 4, param_attr=pkg.ParamAttr(name="tfc")), f, g


def _student(pkg, t_main):
    L = pkg.layers
    dist = (jslim if pkg is pt else tslim).distillation
    x = L.data("img", [1, 8, 8])
    f = L.conv2d(x, 3, 3, padding=1, act="relu")
    g = L.conv2d(f, 2, 3, padding=1)
    s_logits = L.fc(g, 4)
    m = dist.merge_teacher_program(t_main[0], pkg.default_main_program())
    tl, tf, tg = [pkg.default_main_program().global_block.var(m[v.name])
                  for v in t_main[1:]]
    losses = [dist.soft_label_loss(s_logits, tl, temperature=2.0),
              dist.l2_distill_loss(g, tg),
              dist.fsp_loss(f, g, tf, tg),
              dist.multi_teacher_soft_label_loss(
                  s_logits, [tl, L.scale(tl, scale=0.5)], [0.3, 0.7])]
    total = L.sums(losses)
    pkg.optimizer.SGD(0.1).minimize(total)
    return losses


def test_distillation_losses_match_jax():
    progs = []
    for pkg in PKGS:
        tm, _, (tl, tf, tg) = _build(pkg, _teacher)
        progs.append(_build(pkg, lambda p: _student(p, (tm, tl, tf, tg))))
    (jsm, _, _), (tsm, tss, losses) = progs
    assert _program_dict(jsm) == _program_dict(tsm)
    frozen = [p for p in tsm.all_parameters()
              if p.name.startswith("teacher_")]
    assert len(frozen) == 6 and not any(p.trainable for p in frozen)
    jscope, tscope, init = _start_both(tss)
    # the teacher's own weights (its startup would draw the student's)
    rng = np.random.RandomState(4)
    for p in frozen:
        v = (rng.randn(*p.shape) * 0.3).astype(np.float32)
        jscope.set_var(p.name, jnp.asarray(v))
        tscope.set_var(p.name, torch.from_numpy(v))
    feed = {"img": np.random.RandomState(3).randn(6, 1, 8, 8)
            .astype(np.float32)}
    for _ in range(2):
        _carry(jscope, tscope, list(init))
        j, t = _run_both(jsm, tsm, [v.name for v in losses], feed, jscope,
                         tscope)
        for a, b in zip(t, j):
            assert a.item() > 0
            assert abs(a.item() - b.item()) <= OUT_TOL * abs(b.item())


# ---------------------------------------------------------------------------
# light-NAS
# ---------------------------------------------------------------------------

def _sa_run(slim, seed, constrain=None):
    ctrl = slim.SAController(seed=seed, init_temperature=2.0,
                             reduce_rate=0.9)
    ctrl.reset([4, 6, 3], [0, 0, 0], constrain)
    seen = []
    for _ in range(40):
        t = ctrl.next_tokens()
        ctrl.update(t, float(t[0] * 2 - abs(t[1] - 3) + t[2]))
        seen.append(t)
    return seen, ctrl.best_tokens, ctrl.max_reward


def _mlp(pkg, widths=(8, 3)):
    x = pkg.layers.data("nas_x", [16])
    h = x
    for w in widths:
        h = pkg.layers.fc(h, w, act="relu")
    return pkg.layers.fc(h, 4)


class _Space:
    """A search space over the MLP's widths whose reward is a function of
    the tokens: the searcher's loop without training."""
    WIDTHS = [2, 4, 8, 16]

    def __init__(self, pkg):
        self.pkg = pkg

    def init_tokens(self):
        return [1, 1]

    def range_table(self):
        return [4, 4]

    def create_net(self, tokens):
        ws = [self.WIDTHS[t] for t in tokens]
        main, startup, _ = _build(self.pkg, lambda p: _mlp(p, ws))
        return startup, main, lambda s, m: float(sum(ws)) / (1 + ws[0])


def test_nas_matches_jax():
    for seed, constrain in ((3, None), (4, lambda t: sum(t) <= 6)):
        assert _sa_run(jslim, seed, constrain) == \
            _sa_run(tslim, seed, constrain)
    for widths in ((8, 3), (16, 16)):
        (jm, _, _), (tm, _, _) = [_build(pkg, lambda p: _mlp(p, widths))
                                  for pkg in PKGS]
        assert jslim.flops(jm) == tslim.flops(tm) > 0
        assert jslim.latency_estimate(jm) == tslim.latency_estimate(tm) > 0
    (jm, _, _), (tm, _, _) = [_build(pkg, _conv_net) for pkg in PKGS]
    assert jslim.flops(jm) == tslim.flops(tm) > 0
    hist = []
    for pkg, slim in ((pt, jslim), (ptt, tslim)):
        space = _Space(pkg)
        budget = slim.flops(space.create_net([2, 2])[1])
        s = slim.LightNASSearcher(
            space, slim.SAController(seed=1, init_temperature=0.5),
            target_flops=budget, search_steps=8)
        hist.append((s.search(), s.history))
    assert hist[0] == hist[1]


def test_nas_controller_protocol_across_packages():
    """A port agent against a JAX server and a JAX agent against a port
    server, on loopback: the tokens of a local controller of the same
    seed, and the bad-key refusal."""
    for server_slim, agent_slim in ((jslim, tslim), (tslim, jslim)):
        ref = agent_slim.SAController(seed=9)
        ref.reset([5, 5], [2, 2])
        ctrl = server_slim.SAController(seed=9)
        ctrl.reset([5, 5], [2, 2])
        server = server_slim.ControllerServer(ctrl)
        try:
            agent = agent_slim.SearchAgent(server.ip, server.port)
            tokens = agent.next_tokens()
            assert tokens == ref.next_tokens()
            for reward in (1.0, 0.5, 2.0, 0.1):
                ref.update(tokens, reward)
                expect = ref.next_tokens()
                tokens = agent.next_tokens(tokens, reward)
                assert tokens == expect
            bad = agent_slim.SearchAgent(server.ip, server.port, key="x")
            with pytest.raises(RuntimeError, match="bad key"):
                bad.next_tokens()
        finally:
            server.close()


# ---------------------------------------------------------------------------
# the contrib statistics and the fused-activation layer
# ---------------------------------------------------------------------------

def test_contrib_statistics_match_jax(resnet50_qat):
    (jm, _, _), (tm, _, _) = [_build(pkg, _conv_net) for pkg in PKGS]
    jq, tq = [p["main"] for p in resnet50_qat]
    for a, b in ((jm, tm), (jq, tq)):
        outs = []
        for pkg, prog in ((pt, a), (ptt, b)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rows = pkg.contrib.summary(prog)
            outs.append((rows, buf.getvalue(),
                         pkg.contrib.memory_usage(prog, 16),
                         pkg.contrib.op_freq_statistic(prog)))
        assert outs[0] == outs[1]
        assert outs[1][0][1]["PARAMs"] > 0
    assert ptt.contrib.slim is tslim


def test_fused_elemwise_activation_layer_matches_jax():
    def build(pkg):
        x = pkg.layers.data("x", [3, 4])
        y = pkg.layers.data("y", [3])
        return [pkg.contrib.fused_elemwise_activation(
                    x, y, ["relu", "elementwise_add"], axis=0),
                pkg.contrib.layers.fused_elemwise_activation(
                    x, y, ["elementwise_mul", "scale"], axis=0, scale=2.0)]
    (jm, js, jo), (tm, ts, to) = [_build(pkg, build) for pkg in PKGS]
    assert _program_dict(jm) == _program_dict(tm)
    jscope, tscope, _ = _start_both(ts)
    rng = np.random.RandomState(2)
    feed = {"x": rng.randn(2, 3, 4).astype("f"),
            "y": rng.randn(2, 3).astype("f")}
    j, t = _run_both(jm, tm, [v.name for v in to], feed, jscope, tscope)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=OUT_TOL, atol=OUT_TOL)


def test_framework_and_contrib_namespaces_match_jax():
    """The port exports the JAX package's names of the modules it has
    ported: the pass framework from `framework`, WeightNormParamAttr
    from `framework` and the package (it was ported with layer_helper
    but not exported), and contrib's statistics, layers and slim. The
    names left are later slices' (ROADMAP A.12: the debugger, rnn_impl,
    the decoders, extend_optimizer, the distributed reader)."""
    def names(mod):
        return {n for n in dir(mod) if not n.startswith("_")}

    later = {"as_jax_function", "debugger"}
    assert names(pt.framework) - names(ptt.framework) == later
    assert ptt.WeightNormParamAttr is \
        ptt.framework.layer_helper.WeightNormParamAttr
    assert "WeightNormParamAttr" in ptt.__all__
    rnn_impl = {"BasicGRUUnit", "BasicLSTMUnit", "basic_gru", "basic_lstm"}
    assert names(pt.contrib.layers) - names(ptt.contrib.layers) == \
        rnn_impl | {"rnn_impl"}
    assert names(pt.contrib) - names(ptt.contrib) == rnn_impl | {
        "BeamSearchDecoder", "InitState", "StateCell", "TrainingDecoder",
        "decoder", "distributed_batch_reader", "extend_optimizer",
        "extend_with_decoupled_weight_decay", "reader"}
    assert names(jslim) == names(tslim)
