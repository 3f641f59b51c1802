"""The detection stack as a whole, PyTorch port against the JAX package,
on the CPU: `layers/detection.py`, `metrics.DetectionMAP` and the models
the JAX package's detection tests drive, each program built through both
packages' layers DSL (op for op equal, `_program_dict`) and run from the
same startup values (the port's startup run carried to both scopes) on
the same seeded feeds.

  * the toy SSD loop of tests/test_detection_models.py (conv backbone,
    prior_box, ssd_loss, detection_output, detection_map; Adam): every
    step's loss within 1e-5 relative and its mAP within 1e-5;
  * its Mask R-CNN label pipeline (generate_proposal_labels without
    randomness, generate_mask_labels, roi_align into a conv mask head):
    every step's loss within 1e-5 relative;
  * DetectionMAP's current and accumulated mAP over three batches and a
    reset, and its accumulator states, equal;
  * SSD300 (`paddle_tpu_torch/tools/ssd_cases.py`) at 300x300, so the six
    maps and the 8732 priors are the paper's, with the widths divided by
    16, batch 2: the train, test and startup programs equal; the test
    clone (which carries the train step's loss ops), pruned to the loss
    and the detections, from the startup values: the step's loss within
    1e-5 relative and the detection rows (labels exactly, scores and
    boxes within 1e-5);
  * `models/_common.py`'s ffn with JAX's signature: the default `names`
    and gelu, and act="relu" on the first fc, programs equal and one
    forward within 1e-5;
  * every name of JAX's `layers.detection.__all__` in the port's
    `layers` and `layers.detection`.
"""

import types

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.tools.ssd_cases import NUM_PRIORS, ssd300_programs
from test_torch_core_layers import (  # noqa: F401  (autouse fixture)
    _build, _fast_jax_compile, _programs_equal, _start_both)
from test_torch_gpt_inference import _program_dict
from torch_port_common import executor, one_torch_thread  # noqa: F401

OUT_TOL = 1e-5


def _both(build, seed=None):
    """Build with both DSLs (programs equal), start both scopes from the
    port's startup values. Returns (JAX main, port main, outs of each,
    JAX scope, port scope)."""
    (jm, js, jo), (tm, ts, to) = [_build(pkg, build) for pkg in (pt, ptt)]
    assert _programs_equal(jm, tm)
    assert _program_dict(js) == _program_dict(ts)
    if seed is not None:
        ts.random_seed = seed
    jscope, tscope, _ = _start_both(ts)
    return jm, tm, jo, to, jscope, tscope


def _run(jm, tm, jf, tf, feed, jscope, tscope):
    j = executor(pt).run(jm, feed=feed, fetch_list=jf, scope=jscope)
    t = executor(ptt).run(tm, feed=feed, fetch_list=tf, scope=tscope)
    return [np.asarray(v) for v in j], [np.asarray(v) for v in t]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


# ---------------------------------------------------------------------------
# the toy SSD loop
# ---------------------------------------------------------------------------

def _toy_scene(rng, n):
    """One box per image in a 2x2 cell grid, class = cell index + 1."""
    gt_box = np.zeros((n, 1, 4), np.float32)
    gt_label = np.zeros((n, 1, 1), np.int64)
    for i in range(n):
        cell = rng.randint(0, 4)
        cy, cx = divmod(cell, 2)
        x0 = cx * 0.5 + 0.05 + rng.uniform(-0.02, 0.02)
        y0 = cy * 0.5 + 0.05 + rng.uniform(-0.02, 0.02)
        gt_box[i, 0] = [x0, y0, x0 + 0.4, y0 + 0.4]
        gt_label[i, 0, 0] = cell + 1
    return gt_box, gt_label


def _toy_ssd(pkg, hw=32, classes=5):
    L = pkg.layers
    img = L.data("img", [3, hw, hw])
    gt_box = L.data("gt_box", [1, 4])
    gt_label = L.data("gt_label", [1, 1], dtype="int64")
    feat = img
    for ch in (16, 32, 32):
        feat = L.conv2d(feat, ch, 3, padding=1, act="relu")
        feat = L.pool2d(feat, 2, "max", 2)                  # 16, 8, 4
    boxes, vars_ = L.detection.prior_box(feat, img, min_sizes=[12.0],
                                         aspect_ratios=[1.0], flip=False,
                                         clip=True)
    p = 16
    prior = L.reshape(boxes, [p, 4])
    prior_var = L.reshape(vars_, [p, 4])
    loc = L.reshape(L.transpose(L.conv2d(feat, 4, 3, padding=1),
                                [0, 2, 3, 1]), [-1, p, 4])
    conf = L.reshape(L.transpose(L.conv2d(feat, classes, 3, padding=1),
                                 [0, 2, 3, 1]), [-1, p, classes])
    loss = L.mean(L.detection.ssd_loss(loc, conf, gt_box, gt_label, prior,
                                       prior_var))
    det, _ = L.detection.detection_output(
        loc, L.transpose(L.softmax(conf), [0, 2, 1]), prior, prior_var,
        nms_threshold=0.45, keep_top_k=4, score_threshold=0.01)
    lab6 = L.concat([L.cast(gt_label, "float32"), gt_box,
                     L.fill_constant_batch_size_like(gt_box, [-1, 1, 1],
                                                     "float32", 0.0)],
                    axis=2)
    m = L.detection.detection_map(det, lab6, classes)
    pkg.optimizer.Adam(5e-3).minimize(loss)
    return [loss, m, det]


def test_toy_ssd_loop_matches_jax():
    rng = np.random.RandomState(0)
    n, hw = 8, 32
    jm, tm, jo, to, jscope, tscope = _both(_toy_ssd)
    gt_b, gt_l = _toy_scene(rng, n)
    img = rng.rand(n, 3, hw, hw).astype(np.float32)
    for i in range(n):
        x0, y0, x1, y1 = (gt_b[i, 0] * hw).astype(int)
        img[i, gt_l[i, 0, 0] % 3, y0:y1, x0:x1] += 2.0
    feed = {"img": img, "gt_box": gt_b, "gt_label": gt_l}
    losses = []
    for step in range(3):
        j, t = _run(jm, tm, jo, to, feed, jscope, tscope)
        assert _rel(t[0], j[0]) <= OUT_TOL, (step, t[0], j[0])
        np.testing.assert_allclose(t[1], j[1], atol=OUT_TOL)
        np.testing.assert_array_equal(t[2][..., 0], j[2][..., 0])
        np.testing.assert_allclose(t[2], j[2], rtol=OUT_TOL, atol=OUT_TOL)
        losses.append(t[0].item())
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# the Mask R-CNN label pipeline
# ---------------------------------------------------------------------------

_MN, _MR, _MG, _MC, _MRES, _MHW = 2, 8, 2, 3, 8, 32


def _mask_rcnn(pkg):
    L = pkg.layers
    n, R, G, C, res, hw = _MN, _MR, _MG, _MC, _MRES, _MHW

    def d(name, shape, dtype="float32"):
        return L.data(name, shape, dtype=dtype, append_batch_size=False)

    feat, rois_in = d("feat", [n, 8, hw, hw]), d("rois", [n, R, 4])
    gt_cls, gt_box = d("gt_cls", [n, G], "int32"), d("gt_boxes", [n, G, 4])
    im_info, gt_segms = d("im_info", [n, 3]), d("gt_segms", [n, G, hw, hw])
    rois, labels, _, _, _, matched, _ = \
        L.detection.generate_proposal_labels(
            rois_in, gt_cls, None, gt_box, im_info, batch_size_per_im=4,
            fg_fraction=0.5, fg_thresh=0.5, bg_thresh_hi=0.5, class_nums=C,
            use_random=False)
    _, has_mask, mask_int32 = L.detection.generate_mask_labels(
        im_info, gt_cls, None, gt_segms, rois, labels, C, res,
        matched_gt_int32=matched)
    pooled = L.detection.roi_align(
        feat, L.reshape(rois, [-1, 4]), pooled_height=res,
        pooled_width=res, spatial_scale=1.0,
        rois_num=L.fill_constant([n], "int32", 4))
    h = L.conv2d(pooled, 8, 3, padding=1, act="relu")
    logits = L.reshape(L.conv2d(h, C, 1), [-1, C * res * res])
    mask_t = L.reshape(mask_int32, [-1, C * res * res])
    zero = L.fill_constant([1], "int32", 0)
    valid = L.cast(L.greater_equal(mask_t, zero), "float32")
    target = L.cast(L.elementwise_max(mask_t, zero), "float32")
    per = L.sigmoid_cross_entropy_with_logits(logits, target)
    loss = L.reduce_sum(per * valid) / (L.reduce_sum(valid) + 1.0)
    pkg.optimizer.Adam(1e-2).minimize(loss)
    return [loss, has_mask, mask_int32]


def test_mask_rcnn_label_pipeline_matches_jax():
    rng = np.random.RandomState(1)
    n, R, G, hw = _MN, _MR, _MG, _MHW
    feat = rng.randn(n, 8, hw, hw).astype(np.float32) * 0.1
    gt_boxes = np.zeros((n, G, 4), np.float32)
    gt_classes = np.zeros((n, G), np.int32)
    segms = np.zeros((n, G, hw, hw), np.float32)
    rois = np.zeros((n, R, 4), np.float32)
    for i in range(n):
        for g in range(G):
            x0 = 4 + 14 * g
            gt_boxes[i, g] = [x0, 4, x0 + 10, 14]
            gt_classes[i, g] = g + 1
            segms[i, g, 4:14, x0:x0 + 10] = 1.0
            feat[i, g, 4:14, x0:x0 + 10] += 1.0
        for r in range(R):
            g = r % G
            jx, jy = rng.randint(-2, 3, 2)
            x0 = 4 + 14 * g + jx
            rois[i, r] = [x0, 4 + jy, x0 + 10, 14 + jy]
    feed = {"feat": feat, "rois": rois, "gt_cls": gt_classes,
            "gt_boxes": gt_boxes,
            "im_info": np.tile(np.array([[hw, hw, 1.0]], np.float32),
                               (n, 1)), "gt_segms": segms}
    jm, tm, jo, to, jscope, tscope = _both(_mask_rcnn)
    losses = []
    for step in range(3):
        j, t = _run(jm, tm, jo, to, feed, jscope, tscope)
        assert _rel(t[0], j[0]) <= OUT_TOL, (step, t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
        np.testing.assert_array_equal(t[2], j[2])
        losses.append(t[0].item())
    assert t[1].sum() > 0 and losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# metrics.DetectionMAP
# ---------------------------------------------------------------------------

_METRICS = {}


def _dmap(pkg):
    L = pkg.layers
    det = L.data("dm_det", [2, 3, 6], append_batch_size=False)
    gl = L.data("dm_gl", [2, 2, 1], dtype="int64", append_batch_size=False)
    gb = L.data("dm_gb", [2, 2, 4], append_batch_size=False)
    gd = L.data("dm_gd", [2, 2, 1], dtype="int64", append_batch_size=False)
    m = pkg.metrics.DetectionMAP(det, gl, gb, gd, class_num=3,
                                 evaluate_difficult=False)
    _METRICS[pkg] = m
    return list(m.get_map_var())


def test_detection_map_metric_matches_jax():
    """Current and accumulated mAP over a hit, a miss and a mixed batch,
    then reset(); the accumulators equal after each run."""
    jm, tm, jo, to, jscope, tscope = _both(_dmap)
    gl = np.array([[[1], [2]], [[1], [0]]], np.int64)
    gb = np.array([[[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9]],
                   [[0.2, 0.1, 0.5, 0.6], [0, 0, 0, 0]]], np.float32)
    gd = np.array([[[0], [1]], [[0], [0]]], np.int64)
    pad = [-1, -1, -1, -1, -1, -1]
    hit = np.array([[[1, 0.9, 0.1, 0.1, 0.4, 0.4],
                     [2, 0.7, 0.5, 0.5, 0.9, 0.9], pad],
                    [[1, 0.8, 0.2, 0.1, 0.5, 0.6],
                     [1, 0.8, 0.6, 0.6, 0.9, 0.9], pad]], np.float32)
    miss = hit.copy()
    miss[:, :2, 2:4] += 0.4
    mixed = np.concatenate([hit[:1], miss[1:]])
    names = _METRICS[pt]._state_names
    assert names == _METRICS[ptt]._state_names
    seen = []
    for k, det in enumerate((hit, miss, mixed, hit)):
        if k == 3:
            _METRICS[pt].reset(None, scope=jscope)
            _METRICS[ptt].reset(None, scope=tscope)
        feed = {"dm_det": det, "dm_gl": gl, "dm_gb": gb, "dm_gd": gd}
        j, t = _run(jm, tm, jo, to, feed, jscope, tscope)
        np.testing.assert_allclose(t, j, atol=OUT_TOL)
        for nm in names:
            np.testing.assert_array_equal(
                np.asarray(tscope.find_var(nm)),
                np.asarray(jscope.find_var(nm)))
        seen.append([float(v) for v in t])
    assert 0.5 < seen[0][0] == seen[0][1] <= 1.0
    assert seen[1][0] == pytest.approx(0.0, abs=1e-3)
    assert 0.0 < seen[2][1] < seen[0][1] and seen[3] == seen[0]


# ---------------------------------------------------------------------------
# SSD300, narrow
# ---------------------------------------------------------------------------

def _ssd_feed(rng, n, max_boxes=8, classes=21):
    gb = np.zeros((n, max_boxes, 4), np.float32)
    gl = np.zeros((n, max_boxes, 1), np.int64)
    for i in range(n):
        for j in range(rng.randint(1, max_boxes + 1)):
            xy = rng.uniform(0, 0.7, 2)
            gb[i, j] = [*xy, *(xy + rng.uniform(0.05, 0.3, 2))]
            gl[i, j, 0] = rng.randint(1, classes)
    return {"img": rng.rand(n, 3, 300, 300).astype(np.float32),
            "gt_box": gb, "gt_label": gl}


def test_ssd300_narrow_matches_jax():
    (jp, tp) = [ssd300_programs(pkg, div=16) for pkg in (pt, ptt)]
    for k in ("main", "test", "startup"):
        assert _program_dict(jp[k]) == _program_dict(tp[k]), k
    assert tp["priors"].shape == (NUM_PRIORS, 4)
    jscope, tscope, _ = _start_both(tp["startup"])
    feed = _ssd_feed(np.random.RandomState(3), 2)
    # the test clone carries the train step's loss ops too: one forward
    # gives the step's loss and the detections from the same weights;
    # both clones pruned to those two (DetectionMAP's values:
    # test_detection_map_metric_matches_jax)
    jf, tf = [[p["loss"].name, p["det"].name] for p in (jp, tp)]
    j, t = _run(jp["test"]._prune(jf), tp["test"]._prune(tf), jf, tf, feed,
                jscope, tscope)
    assert np.isfinite(t[0]).all() and _rel(t[0], j[0]) <= OUT_TOL
    assert t[1].shape == (2, 200, 6) and (t[1][..., 0] >= 0).any()
    np.testing.assert_array_equal(t[1][..., 0], j[1][..., 0])
    np.testing.assert_allclose(t[1], j[1], rtol=OUT_TOL, atol=OUT_TOL)


# ---------------------------------------------------------------------------
# models/_common.py ffn, and the layers namespace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", [None, "relu"])
def test_common_ffn_matches_jax(act):
    from paddle_tpu.models import _common as jc
    from paddle_tpu_torch.models import _common as tc
    cfg = types.SimpleNamespace(hidden=6, ffn=10, init_range=0.02)

    def build(pkg):
        common = jc if pkg is pt else tc
        x = pkg.layers.data("x", [3, 6])
        kw = {} if act is None else {"act": act}
        return [common.ffn(x, cfg, "l0", **kw)]

    jm, tm, jo, to, jscope, tscope = _both(build)
    types_ = [op.type for op in tm.global_block.ops]
    assert ("gelu" in types_) == (act is None)
    assert ("relu" in types_) == (act == "relu")
    feed = {"x": np.random.RandomState(5).randn(2, 3, 6).astype(np.float32)}
    j, t = _run(jm, tm, jo, to, feed, jscope, tscope)
    np.testing.assert_allclose(t[0], j[0], rtol=OUT_TOL, atol=OUT_TOL)


def test_detection_layers_namespace():
    import paddle_tpu.layers.detection as jd
    assert len(jd.__all__) == 32
    assert ptt.layers.detection.__all__ == jd.__all__
    for name in jd.__all__:
        assert callable(getattr(ptt.layers, name)), name
        assert getattr(ptt.layers, name) is getattr(ptt.layers.detection,
                                                    name)
