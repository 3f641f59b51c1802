"""SSD300's programs (Liu et al., "SSD: Single Shot MultiBox Detector",
ECCV 2016, sections 2.2-3.1 and Fig. 2) as builders over a package
argument.

`ssd300_programs(pkg, ...)` builds them in `pkg` (this package, or any
package with the same layers DSL): VGG-16 through conv5_3 (pool3 with
ceil mode, so 300 -> 38 at conv4_3; pool5 3x3 stride 1), conv6 3x3 with
dilation 6 and conv7 1x1 (the fc6/fc7 of VGG made convolutional), the
extra layers conv8_2 .. conv11_2, conv4_3 L2-normalised over channels
and scaled by a learned per-channel parameter that starts at 20, and
`multi_box_head` over the six maps (38, 19, 10, 5, 3, 1): 8732 priors.
The train program ends in `ssd_loss` and Momentum; the test clone ends in
`detection_output` and `metrics.DetectionMAP`.
tests/test_torch_detection_models.py runs a narrow one (the widths
divided) through both packages on the CPU; chip_smoke.py's phase 4n runs
the full one on the card.
"""

# (name, output channels, kernel, stride, padding) of the extra layers,
# each a 1x1 reduction then this 3x3 conv (the paper's Fig. 2)
EXTRAS = (("conv8", 256, 512, 2, 1), ("conv9", 128, 256, 2, 1),
          ("conv10", 128, 256, 1, 0), ("conv11", 128, 256, 1, 0))
ASPECT_RATIOS = [[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0], [2.0]]
STEPS = [8, 16, 32, 64, 100, 300]
NUM_PRIORS = 8732


def _conv(pkg, x, ch, k, name, stride=1, padding=0, dilation=1):
    return pkg.layers.conv2d(
        x, ch, k, stride=stride, padding=padding, dilation=dilation,
        act="relu", param_attr=pkg.ParamAttr(name=name + "_w"),
        bias_attr=pkg.ParamAttr(name=name + "_b"))


def _vgg16(pkg, img, div):
    """VGG-16 through conv5_3 and SSD's conv6/conv7: (conv4_3, conv7)."""
    L = pkg.layers
    h = img
    feats = {}
    for block, (ch, reps) in enumerate(((64, 2), (128, 2), (256, 3),
                                        (512, 3), (512, 3)), 1):
        for i in range(1, reps + 1):
            h = _conv(pkg, h, ch // div, 3, f"conv{block}_{i}", padding=1)
        feats[block] = h
        if block < 5:
            h = L.pool2d(h, 2, "max", 2, ceil_mode=block == 3)
    h = L.pool2d(h, 3, "max", 1, pool_padding=1)          # pool5
    h = _conv(pkg, h, 1024 // div, 3, "conv6", padding=6, dilation=6)
    h = _conv(pkg, h, 1024 // div, 1, "conv7")
    return feats[4], h


def ssd300_network(pkg, img, num_classes, div=1):
    """SSD300 on `img` [n, 3, 300, 300]: (locs [n, 8732, 4], confs
    [n, 8732, num_classes], prior boxes [8732, 4], prior variances)."""
    L = pkg.layers
    conv4_3, h = _vgg16(pkg, img, div)
    scale = L.create_parameter(
        [512 // div], "float32", attr=pkg.ParamAttr(name="conv4_3_norm_s"),
        default_initializer=pkg.initializer.Constant(20.0))
    maps = [L.elementwise_mul(L.l2_normalize(conv4_3, axis=1), scale,
                              axis=1), h]
    for name, mid, out, stride, pad in EXTRAS:
        h = _conv(pkg, h, mid // div, 1, name + "_1")
        h = _conv(pkg, h, out // div, 3, name + "_2", stride=stride,
                  padding=pad)
        maps.append(h)
    return L.multi_box_head(
        maps, img, base_size=300, num_classes=num_classes,
        aspect_ratios=ASPECT_RATIOS, min_ratio=20, max_ratio=90,
        steps=STEPS, flip=True, clip=True, kernel_size=3, pad=1)


def ssd300_programs(pkg, num_classes=21, max_boxes=8, div=1, lr=1e-3,
                    momentum=0.9, nms_threshold=0.45, nms_top_k=400,
                    keep_top_k=200, score_threshold=0.01):
    """SSD300's train program (ssd_loss summed over the priors and the
    batch, over the number of ground-truth boxes; Momentum(lr,
    momentum)), its test clone ending in detection_output (softmax
    confidences as [n, num_classes, 8732]) and DetectionMAP, and their
    startup program. Feeds: "img" [n, 3, 300, 300], "gt_box" [n,
    max_boxes, 4] normalized (zero rows pad), "gt_label" [n, max_boxes,
    1] int64. Returns a dict: main, test, startup, loss, det (the
    detections), cur_map, accum_map, metric (the DetectionMAP, for
    reset), priors and prior_vars (the prior boxes and their
    variances)."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        img = L.data("img", [3, 300, 300])
        gt_box = L.data("gt_box", [max_boxes, 4])
        gt_label = L.data("gt_label", [max_boxes, 1], dtype="int64")
        locs, confs, priors, pvars = ssd300_network(pkg, img, num_classes,
                                                    div)
        loss_map = L.detection.ssd_loss(locs, confs, gt_box, gt_label,
                                        priors, pvars)
        # the paper's normalisation: the summed loss over the number of
        # ground-truth boxes (labels are 1-based; padding rows are 0)
        n_gt = L.reduce_sum(L.sign(L.cast(gt_label, "float32")))
        loss = L.reduce_sum(loss_map) / n_gt
        test = main.clone(for_test=True)
        with pkg.program_guard(test, startup):
            scores = L.transpose(L.softmax(confs), [0, 2, 1])
            det, _ = L.detection.detection_output(
                locs, scores, priors, pvars, nms_threshold=nms_threshold,
                nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                score_threshold=score_threshold)
            metric = pkg.metrics.DetectionMAP(
                det, gt_label, gt_box, class_num=num_classes)
            cur_map, accum_map = metric.get_map_var()
        pkg.optimizer.Momentum(lr, momentum).minimize(loss)
    return {"main": main, "test": test, "startup": startup, "loss": loss,
            "det": det, "cur_map": cur_map, "accum_map": accum_map,
            "metric": metric, "priors": priors, "prior_vars": pvars}
