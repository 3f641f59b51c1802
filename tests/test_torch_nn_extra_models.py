"""The op library's long tail as a whole, PyTorch port against the JAX
package, on the CPU: `layers/nn_extra.py` and the DCNv2 ResNet-50 of
`paddle_tpu_torch/tools/dcn_cases.py`, each program built through both
packages' layers DSL (op for op equal, `_program_dict`) and run from the
same startup values (the port's startup run carried to both scopes) on
the same seeded feeds.

  * the DCNv2 ResNet-50 at the full [3, 4, 6, 3] layout and 224x224 built
    in both packages, not run: main, test and startup programs equal, 13
    deformable units, each fed by a zero-initialised 27-channel conv;
  * a narrow one (one bottleneck a stage, so three deformable units;
    widths divided by 16; 32x32 images, batch 4) two Momentum steps, each
    from the JAX run's state: the loss within 1e-5 relative, the
    gradients of every deformable filter and offset conv and of the first
    conv within op_test's 5e-3 (max relative error); the offset convs
    made non-zero first, so the samples lie off the grid;
  * a program of the long-tail layers (the samplers, pools, CTR and
    ranking layers, the losses, the recurrences, unique, hash and
    edit_distance): program and startup equal in both packages, and the
    port runs it to outputs of the declared shapes, finite (each rule
    against JAX's: test_torch_nn_extra_ops.py);
  * the `layers` namespace: every name of JAX's `layers.nn_extra.__all__`
    resolves in the port's `layers` and `layers.nn_extra`;
    `layers.resize_bilinear` is nn_extra's in both, with its positional
    order; `soft_relu` and `adaptive_pool3d` raise NotImplementedError
    at build time in both, `npair_loss` an AttributeError in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.tools.dcn_cases import (NUM_DEFORMABLE,
                                              dcn_resnet50_programs)
from test_torch_core_layers import (  # noqa: F401  (autouse fixture)
    _build, _fast_jax_compile, _programs_equal, _start_both)
from test_torch_gpt_inference import _program_dict
from torch_port_common import executor, one_torch_thread  # noqa: F401

OUT_TOL = 1e-5
GRAD_TOL = 5e-3


def _op_test_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = max(np.abs(a).max(initial=0), np.abs(b).max(initial=0), 1e-3)
    return np.abs(a - b).max(initial=0) / den


def _run(jm, tm, jf, tf, feed, jscope, tscope):
    j = executor(pt).run(jm, feed=feed, fetch_list=jf, scope=jscope)
    t = executor(ptt).run(tm, feed=feed, fetch_list=tf, scope=tscope)
    return [np.asarray(v) for v in j], [np.asarray(v) for v in t]


# ---------------------------------------------------------------------------
# the DCNv2 ResNet-50
# ---------------------------------------------------------------------------

@pytest.fixture
def _shared_jax_shape_inference(monkeypatch):
    """The JAX build's shape inference, once for each distinct (op type,
    attrs, input shapes and dtypes): it traces the op's rule with
    jax.eval_shape, a pure function of those, and the deformable units
    of a stage's later blocks repeat one another's."""
    from paddle_tpu.framework import registry as jreg
    infer = jreg.infer_op_shapes
    seen = {}

    def shared(op, block):
        if op.type.endswith("_grad"):
            return infer(op, block)
        key = (op.type, repr(sorted(op.attrs.items())),
               tuple((s, tuple((tuple(block.var(n).shape), block.var(n)
                                .dtype) for n in ns))
                     for s, ns in sorted(op.inputs.items()) if ns))
        if key not in seen:
            infer(op, block)
            seen[key] = [[(block.var(n).shape, block.var(n).dtype)
                          for n in ns]
                         for _, ns in sorted(op.outputs.items())]
            return
        for (_, ns), got in zip(sorted(op.outputs.items()), seen[key]):
            for n, (shape, dtype) in zip(ns, got):
                v = block.var(n) if block.has_var(n) else \
                    block.create_var(name=n)
                v.shape, v.dtype = shape, dtype

    monkeypatch.setattr(jreg, "infer_op_shapes", shared)


def test_dcn_resnet50_full_programs_equal(_shared_jax_shape_inference):
    jp, tp = [dcn_resnet50_programs(pkg) for pkg in (pt, ptt)]
    for k in ("main", "test", "startup"):
        assert _program_dict(jp[k]) == _program_dict(tp[k]), k
    for P in (jp, tp):
        rec = P["deformable"]
        assert len(rec) == NUM_DEFORMABLE == 13
        types = [op.type for op in P["main"].global_block.ops]
        assert types.count("deformable_conv") == 13
        assert types.count("deformable_conv_grad") == 13
        assert [r["stride"] for r in rec] == [2, 1, 1, 1, 2, 1, 1, 1, 1, 1,
                                               2, 1, 1]
        assert [tuple(r["offset_mask"].shape[1:2]) for r in rec] == \
            [(27,)] * 13
        assert tuple(P["logits"].shape) == (-1, 1000)


def test_dcn_resnet50_narrow_trains_as_jax():
    """Two Momentum steps, each from the same state: before each, the JAX
    scope's persistables (parameters, velocities, BN statistics) are
    carried to the port with io.set_params_from_numpy. Batch 4: at batch
    2, BN over the two values of conv5's 1x1 maps turns rounding
    differences into 7.6e-3 of a gradient (op_test's measure) and, carried
    once, into 1e-2 of step 2's loss (ROADMAP §C, kinks with
    batch_norm); at batch 4 the worst gradient lies 2e-4 apart."""
    jp, tp = [dcn_resnet50_programs(pkg, class_num=10, image=32,
                                    stages=(1, 1, 1, 1), div=16, lr=1e-3)
              for pkg in (pt, ptt)]
    for k in ("main", "startup"):
        assert _program_dict(jp[k]) == _program_dict(tp[k]), k
    assert len(tp["deformable"]) == 3
    jscope, tscope, init = _start_both(tp["startup"])
    # the offset convs off their zero start: the samples leave the grid
    rng = np.random.RandomState(7)
    blk = tp["main"].global_block
    for op in blk.ops:
        w = op.inputs.get("Filter", [None])[0]
        if op.type == "conv2d" and blk.var(w).shape[0] == 27:
            jscope.set_var(w, jnp.asarray(
                rng.randn(*init[w].shape).astype(np.float32) * 0.1))
    offset_w = [n for n in init if blk.var(n).shape[:1] == (27,)
                and n.endswith(".w_0")]
    assert len(offset_w) == 3
    grads = [r["filter"] + "@GRAD" for r in tp["deformable"]] + \
        [w + "@GRAD" for w in offset_w] + ["conv2d_0.w_0@GRAD"]
    feed = {"img": rng.rand(4, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    fetch = [tp["loss"].name] + grads
    names = [n for n in jscope.var_names() if n in init
             or n.startswith("momentum")]
    losses = []
    for step in range(2):
        ptt.io.set_params_from_numpy(
            tscope, {n: np.asarray(jscope.find_var(n)) for n in names},
            "cpu")
        j, t = _run(jp["main"], tp["main"], fetch, fetch, feed, jscope,
                    tscope)
        assert np.isfinite(t[0]).all()
        assert abs(float(t[0]) - float(j[0])) <= OUT_TOL * abs(float(j[0]))
        for name, a, b in zip(grads, t[1:], j[1:]):
            assert np.abs(a).max() > 0, name
            assert _op_test_rel(a, b) <= GRAD_TOL, (step, name)
        losses.append(float(t[0]))
    assert losses[1] != losses[0]


# ---------------------------------------------------------------------------
# the long-tail layers in one program
# ---------------------------------------------------------------------------

def _layers_program(pkg):
    L = pkg.layers

    def d(name, shape, dtype="float32", grad=True):
        return L.data(name, shape, dtype=dtype, append_batch_size=False,
                      stop_gradient=not grad)

    img = d("img", [2, 4, 6, 6])
    vec = d("vec", [4, 6])
    seq = d("seq", [2, 5, 8])
    ids = d("ids", [6, 1], "int64", False)
    lab = d("lab", [4, 1], "int64", False)
    prob = d("prob", [4, 1])
    rois = d("rois", [3, 4], grad=False)
    tok = d("tok", [3, 5], "int64", False)
    tok2 = d("tok2", [3, 4], "int64", False)
    outs = []
    theta = L.reshape(L.fc(L.reshape(vec, [4, 6]), 6), [4, 2, 3])
    grid = L.affine_grid(theta, [4, 1, 3, 3])
    outs.append(L.grid_sampler(L.reshape(img, [4, 2, 6, 6]), grid))
    outs.append(L.affine_channel(img, act="relu"))
    # the DCN units' 3x3 masked form: the DCN tests above; here two
    # groups, a 2x2 kernel, a stride, a dilation and no mask
    off = L.conv2d(img, 16, 2, stride=2, padding=[1, 0], dilation=2)
    outs.append(L.deformable_conv(img, off, None, 3, 2, stride=2,
                                  padding=[1, 0], dilation=2,
                                  deformable_groups=2, modulated=False))
    outs.append(L.psroi_pool(L.conv2d(img, 8, 1), rois, 2, 1.0, 2, 2))
    outs += [L.pixel_shuffle(L.conv2d(img, 8, 1), 2),
             L.space_to_depth(img, 2), L.shuffle_channel(img, 2),
             L.unfold(img, 3, paddings=1), L.im2sequence(img, 2, 2),
             L.temporal_shift(img, 2)]
    outs += [L.relu6(vec), L.brelu(vec, 0.1, 1.0), L.hard_swish(vec),
             L.stanh(vec), L.selu(vec)]
    outs.append(L.bilinear_tensor_product(vec, vec, 3))
    outs.append(L.row_conv(seq, 3, act="tanh"))
    proj, _ = L.dynamic_lstmp(seq, 8, 3)
    outs.append(proj)
    h, c = L.lstm_unit(vec, L.fc(vec, 2), L.fc(vec, 2))
    outs += [h, c]
    mm, _ = L.match_matrix_tensor(seq, seq, 2)
    outs.append(mm)
    outs.append(L.fsp_matrix(img, img))
    outs.append(L.data_norm(vec))
    outs.append(L.continuous_value_model(L.abs(vec), vec))
    outs += [L.rank_loss(prob, L.fc(vec, 1), L.fc(vec, 1)),
             L.margin_rank_loss(prob, L.fc(vec, 1), L.fc(vec, 1)),
             L.teacher_student_sigmoid_loss(L.fc(vec, 1), prob),
             L.center_loss(vec, lab, 3, 0.1),
             L.dice_loss(L.softmax(vec), lab)]
    outs.append(L.image_resize(img, [9, 9]))
    outs.append(L.resize_nearest(img, [3, 4]))
    outs.append(L.crop(img, [2, 2, 3, 3], [0, 1, 2, 3]))
    outs.append(L.pad_constant_like(img, L.crop(img, [2, 2, 3, 3]), 0.5))
    outs.append(L.multiplex([vec, L.scale(vec, 2.0)],
                            L.fill_constant([4, 1], "int32", 1)))
    u, ui = L.unique(ids)
    uc, uci, ucc = L.unique_with_counts(L.reshape(ids, [6]))
    outs += [u, ui, uc, uci, ucc, L.hash(ids, 1000, num_hash=2)]
    dist, num = L.edit_distance(tok, tok2, normalized=False)
    outs += [dist, num]
    miou, wrong, correct = L.mean_iou(L.cast(lab, "int32"),
                                      L.cast(lab, "int32"), 4)
    outs += [miou, wrong, correct]
    outs.append(L.similarity_focus(img, 1, [0, 2]))
    outs.append(L.rank(img))
    return outs


def test_nn_extra_layers_build_as_jax():
    """Both DSLs build the same program and startup; the port runs it
    (the rules against JAX's: test_torch_nn_extra_ops.py)."""
    (jm, js, jo), (tm, ts, to) = [_build(pkg, _layers_program)
                                  for pkg in (pt, ptt)]
    assert _programs_equal(jm, tm)
    assert _program_dict(js) == _program_dict(ts)
    tscope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(ts, scope=tscope)
    rng = np.random.RandomState(11)
    feed = {"img": rng.randn(2, 4, 6, 6).astype(np.float32),
            "vec": rng.randn(4, 6).astype(np.float32),
            "seq": rng.randn(2, 5, 8).astype(np.float32),
            "ids": np.array([[5], [2], [5], [9], [2], [5]], np.int64),
            "lab": np.array([[0], [2], [2], [1]], np.int64),
            "prob": rng.rand(4, 1).astype(np.float32),
            "rois": np.array([[0, 0, 4, 4], [1, 2, 5, 5], [2, 0, 3, 5]],
                             np.float32),
            "tok": rng.randint(0, 4, (3, 5)).astype(np.int64),
            "tok2": rng.randint(0, 4, (3, 4)).astype(np.int64)}
    out = exe.run(tm, feed=feed, fetch_list=[o.name for o in to],
                  scope=tscope)
    for v, a in zip(to, out):
        a = np.asarray(a)
        assert a.shape == tuple(d if d != -1 else a.shape[i]
                                for i, d in enumerate(v.shape)), v.name
        assert a.dtype.kind != "f" or np.isfinite(a).all(), v.name


# ---------------------------------------------------------------------------
# the layers namespace
# ---------------------------------------------------------------------------

def test_nn_extra_layers_namespace():
    import paddle_tpu.layers.nn_extra as jx
    assert len(jx.__all__) == 67
    assert ptt.layers.nn_extra.__all__ == jx.__all__
    for name in jx.__all__:
        assert callable(getattr(ptt.layers, name)), name
        assert getattr(ptt.layers, name) is getattr(ptt.layers.nn_extra,
                                                    name)
    for pkg in (pt, ptt):
        assert pkg.layers.resize_bilinear is pkg.layers.nn_extra \
            .resize_bilinear
        assert pkg.layers.resize_nearest is pkg.layers.nn_extra \
            .resize_nearest
        assert pkg.layers.nn.resize_bilinear is not \
            pkg.layers.resize_bilinear
    # the positional order (input, out_shape, scale, name, align_corners)
    (jm, _, _), (tm, _, _) = [_build(pkg, lambda p: [
        p.layers.resize_bilinear(p.layers.data("x", [3, 4, 4]), [8, 6],
                                 None, None, False)]) for pkg in (pt, ptt)]
    assert _programs_equal(jm, tm)
    op = tm.global_block.ops[-1]
    assert op.type == "bilinear_interp" and op.attrs["out_h"] == 8 and \
        op.attrs["align_corners"] is False


@pytest.mark.parametrize("layer,exc", [
    ("soft_relu", NotImplementedError), ("adaptive_pool3d",
                                         NotImplementedError),
    ("npair_loss", AttributeError)])
def test_nn_extra_layers_raise_as_jax(layer, exc):
    def build(pkg):
        L = pkg.layers
        x = L.data("x", [2, 4, 4, 4])
        if layer == "soft_relu":
            return L.soft_relu(x)
        if layer == "adaptive_pool3d":
            return L.adaptive_pool3d(x, 2)
        return L.npair_loss(L.data("a", [4]), L.data("p", [4]),
                            L.data("l", [1]))
    for pkg in (pt, ptt):
        with pytest.raises(exc):
            _build(pkg, build)
