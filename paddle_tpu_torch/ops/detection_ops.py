"""Detection ops (reference: paddle/fluid/operators/detection/).

Port of `paddle_tpu/ops/detection_ops.py`. The outputs are JAX's
fixed-size ones: where the reference emits variable-length LoD results
(multiclass_nms, generate_proposals), the rules return padded top-K
tensors with a validity count, so a rule never reads a value back to the
host and every shape is static.

What JAX gives by construction is spelled out here:
  * `jax.lax.top_k` puts the lower index first among equal values and
    +0.0 before -0.0; `_top_k` is a stable descending sort with that
    order. `jnp.argsort` is stable and takes -0.0 and +0.0 as equal;
    `_argsort` normalises the zeros (a GPU radix sort would part them)
    and sorts stably. `torch.argmax` and `jnp.argmax` both take the first
    maximum.
  * an index of -1 (unmatched) is clipped to 0 before it gathers, and a
    scatter that JAX drops gets weight 0: a -1 in torch's advanced
    indexing would read, or write, the LAST row without an error.
  * the greedy loops (`jax.lax.fori_loop` in NMS and bipartite matching)
    are Python loops over the loop index, batched over images and
    classes as JAX vmaps them, with no host read inside; on the meta
    device (build-time shape inference) they are skipped.
"""

import math

import torch
import torch.nn.functional as F

from ..framework.registry import register_op


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _top_k(x, k):
    """`jax.lax.top_k` along the last dim: descending, the lower index
    first among equal values, +0.0 before -0.0."""
    key = x + 0.0                   # -0.0 + 0.0 is +0.0
    if x.is_floating_point():
        neg0 = (x == 0) & torch.signbit(x)
        tiny = torch.finfo(x.dtype).tiny * torch.finfo(x.dtype).eps
        key = torch.where(neg0, torch.full_like(x, -tiny), key)
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(x, -1, idx), idx


def _argsort(x, dim=-1):
    """`jnp.argsort` (stable, ascending; -0.0 and +0.0 equal)."""
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    elif x.is_floating_point():
        x = x + 0.0
    return torch.argsort(x, dim=dim, stable=True)


def _inverse_perm(order):
    """argsort of a permutation along the last dim: its inverse."""
    ar = torch.arange(order.shape[-1], device=order.device)
    return torch.empty_like(order).scatter_(
        -1, order, ar.expand(order.shape).contiguous())


def _iou_matrix(a, b, normalized=True):
    """IoU of boxes a [..., N, 4] against b [..., M, 4]: [..., N, M]."""
    one = 0.0 if normalized else 1.0
    area_a = (a[..., 2] - a[..., 0] + one) * (a[..., 3] - a[..., 1] + one)
    area_b = (b[..., 2] - b[..., 0] + one) * (b[..., 3] - b[..., 1] + one)
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    iw = torch.clamp(ix2 - ix1 + one, min=0.0)
    ih = torch.clamp(iy2 - iy1 + one, min=0.0)
    inter = iw * ih
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter
                    + 1e-10)


def _nms_keep(boxes, valid, nms_thresh, normalized=True):
    """Greedy NMS keep-mask over pre-sorted (desc score) boxes
    [..., k, 4]: JAX's fori_loop, i suppressing every later j that
    overlaps it while i is kept, batched over the leading dims."""
    k = boxes.shape[-2]
    iou = _iou_matrix(boxes, boxes, normalized)
    if iou.is_meta:
        return valid
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    spare = ~((iou > nms_thresh) & later)          # [..., k, k]
    keep = valid
    for i in range(k):
        keep = keep & (spare[..., i, :] | ~keep[..., i:i + 1])
    return keep


def _batch_index(rois_num, n, r, device):
    """`jnp.repeat(arange(n), rois_num, total_repeat_length=r)`: rows past
    the counts' sum take the last image, as JAX's does."""
    if rois_num is None:
        return torch.zeros(r, dtype=torch.long, device=device)
    counts = rois_num.reshape(-1).to(torch.long)
    starts = torch.cumsum(counts, 0) - counts
    rows = torch.arange(r, device=device)
    return torch.searchsorted(starts.contiguous(), rows, right=True) - 1


def _true_div(a, d):
    """a / d rounded as IEEE division (JAX's): a CUDA tensor divided by a
    Python number is a product with the number's rounded reciprocal, one
    ulp off where a floor or ceil of the quotient decides a window."""
    return a / torch.full((), d, dtype=a.dtype, device=a.device)


def _rows(t, idx):
    """t [n, m, ...] gathered along dim 1 by idx [n, k]: [n, k, ...]."""
    ar = torch.arange(t.shape[0], device=t.device)[:, None]
    return t[ar, idx]


def _log_cap():
    # the reference clips dw/dh at log(1000/16), computed in float32 as
    # JAX's jnp.log of the Python float is
    return torch.log(torch.tensor(1000.0 / 16, dtype=torch.float32))


def _encode_vs(anchor, mgt):
    """Variance-free encoded regression targets of matched gts (the rpn
    and retinanet assigners)."""
    aw = anchor[..., 2] - anchor[..., 0] + 1
    ah = anchor[..., 3] - anchor[..., 1] + 1
    acx = anchor[..., 0] + aw / 2
    acy = anchor[..., 1] + ah / 2
    gw = mgt[..., 2] - mgt[..., 0] + 1
    gh = mgt[..., 3] - mgt[..., 1] + 1
    gcx = mgt[..., 0] + gw / 2
    gcy = mgt[..., 1] + gh / 2
    return torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                        torch.log(gw / aw), torch.log(gh / ah)], dim=-1)


# ---------------------------------------------------------------------------
# priors / anchors / coders
# ---------------------------------------------------------------------------

@register_op("prior_box", not_differentiable=True, grad_free=True)
def _prior_box(ctx, ins, attrs):
    """SSD prior boxes (reference: detection/prior_box_op.cc). Input
    feature map [n,c,h,w] + image [n,c,H,W]; outputs Boxes/Variances
    [h, w, num_priors, 4] (normalized xmin,ymin,xmax,ymax)."""
    feat, image = ins["Input"][0], ins["Image"][0]
    dev = feat.device
    h, w = feat.shape[2], feat.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    ars = [1.0]
    for ar in attrs.get("aspect_ratios", []):
        ar = float(ar)
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(ar)
            if attrs.get("flip", True):
                ars.append(1.0 / ar)
    step_w = attrs.get("step_w", 0.0) or img_w / w
    step_h = attrs.get("step_h", 0.0) or img_h / h
    offset = attrs.get("offset", 0.5)

    widths, heights = [], []
    for si, ms in enumerate(min_sizes):
        for ar in ars:
            widths.append(ms * (ar ** 0.5))
            heights.append(ms / (ar ** 0.5))
        if max_sizes:
            mx = max_sizes[si]  # positional: duplicate min_sizes are legal
            widths.append((ms * mx) ** 0.5)
            heights.append((ms * mx) ** 0.5)
    num_priors = len(widths)
    widths = torch.tensor(widths, dtype=torch.float32, device=dev) / img_w
    heights = torch.tensor(heights, dtype=torch.float32, device=dev) / img_h

    cx = (torch.arange(w, device=dev) + offset) * step_w / img_w
    cy = (torch.arange(h, device=dev) + offset) * step_h / img_h
    cx = cx[None, :, None].expand(h, w, 1)
    cy = cy[:, None, None].expand(h, w, 1)
    boxes = torch.stack([cx - widths / 2, cy - heights / 2,
                         cx + widths / 2, cy + heights / 2], dim=-1)
    if attrs.get("clip", True):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
                       dtype=torch.float32, device=dev)
    variances = var.expand(h, w, num_priors, 4).contiguous()
    return {"Boxes": [boxes.float()], "Variances": [variances]}


@register_op("anchor_generator", not_differentiable=True, grad_free=True)
def _anchor_generator(ctx, ins, attrs):
    """RPN anchors (reference: detection/anchor_generator_op.cc). Outputs
    Anchors/Variances [h, w, num_anchors, 4] in input-image pixels."""
    feat = ins["Input"][0]
    dev = feat.device
    h, w = feat.shape[2], feat.shape[3]
    sizes = [float(s) for s in attrs.get("anchor_sizes", [64., 128., 256.])]
    ratios = [float(r) for r in attrs.get("aspect_ratios", [0.5, 1.0, 2.0])]
    stride = [float(s) for s in attrs.get("stride", [16.0, 16.0])]
    offset = attrs.get("offset", 0.5)
    ws, hs = [], []
    for r in ratios:
        for s in sizes:
            area = s * s
            ws.append((area / r) ** 0.5)
            hs.append(((area / r) ** 0.5) * r)
    ws = torch.tensor(ws, dtype=torch.float32, device=dev)
    hs = torch.tensor(hs, dtype=torch.float32, device=dev)
    cx = (torch.arange(w, device=dev) + offset) * stride[0]
    cy = (torch.arange(h, device=dev) + offset) * stride[1]
    cx = cx[None, :, None].expand(h, w, 1)
    cy = cy[:, None, None].expand(h, w, 1)
    anchors = torch.stack([cx - 0.5 * ws, cy - 0.5 * hs,
                           cx + 0.5 * ws, cy + 0.5 * hs], dim=-1)
    var = torch.tensor(attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
                       dtype=torch.float32, device=dev)
    variances = var.expand(anchors.shape).contiguous()
    return {"Anchors": [anchors.float()], "Variances": [variances]}


@register_op("box_coder", no_grad_inputs={"PriorBox", "PriorBoxVar"})
def _box_coder(ctx, ins, attrs):
    """Center-size encode/decode (reference: detection/box_coder_op.cc).
    PriorBox [m,4], TargetBox [n,m,4] (decode) or [n,4] (encode)."""
    prior = ins["PriorBox"][0]
    target = ins["TargetBox"][0]
    pvar = ins.get("PriorBoxVar", [None])[0]
    code_type = attrs.get("code_type", "decode_center_size")
    norm = attrs.get("box_normalized", True)
    one = 0.0 if norm else 1.0

    pw = prior[:, 2] - prior[:, 0] + one
    ph = prior[:, 3] - prior[:, 1] + one
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if pvar is None:
        pvar = torch.ones((prior.shape[0], 4), dtype=prior.dtype,
                          device=prior.device)

    if code_type.startswith("encode"):
        tw = target[:, 2] - target[:, 0] + one
        th = target[:, 3] - target[:, 1] + one
        tcx = target[:, 0] + tw * 0.5
        tcy = target[:, 1] + th * 0.5
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log(tw[:, None] / pw[None, :])
        dh = torch.log(th[:, None] / ph[None, :])
        out = torch.stack([dx, dy, dw, dh], dim=-1) / pvar[None, :, :]
        return {"OutputBox": [out]}

    t = target  # [n, m, 4]
    v = pvar[None, :, :]
    cx = v[..., 0] * t[..., 0] * pw[None, :] + pcx[None, :]
    cy = v[..., 1] * t[..., 1] * ph[None, :] + pcy[None, :]
    w_ = torch.exp(v[..., 2] * t[..., 2]) * pw[None, :]
    h_ = torch.exp(v[..., 3] * t[..., 3]) * ph[None, :]
    out = torch.stack([cx - w_ * 0.5, cy - h_ * 0.5,
                       cx + w_ * 0.5 - one, cy + h_ * 0.5 - one], dim=-1)
    return {"OutputBox": [out]}


@register_op("iou_similarity", not_differentiable=True, grad_free=True)
def _iou_similarity(ctx, ins, attrs):
    """reference: detection/iou_similarity_op.cc — X [n,4] vs Y [m,4]."""
    return {"Out": [_iou_matrix(ins["X"][0], ins["Y"][0],
                                attrs.get("box_normalized", True))]}


@register_op("yolo_box", not_differentiable=True, grad_free=True)
def _yolo_box(ctx, ins, attrs):
    """Decode YOLOv3 head output (reference: detection/yolo_box_op.cc).
    X [n, an*(5+cls), h, w], ImgSize [n,2] -> Boxes [n, h*w*an, 4],
    Scores [n, h*w*an, cls]."""
    x, img_size = ins["X"][0], ins["ImgSize"][0]
    dev = x.device
    anchors = [int(a) for a in attrs["anchors"]]
    an = len(anchors) // 2
    cls = attrs["class_num"]
    conf_thresh = attrs.get("conf_thresh", 0.01)
    downsample = attrs.get("downsample_ratio", 32)
    n, _, h, w = x.shape
    x = x.reshape(n, an, 5 + cls, h, w)
    gx = (torch.arange(w, device=dev)[None, None, None, :] +
          torch.sigmoid(x[:, :, 0])) / w
    gy = (torch.arange(h, device=dev)[None, None, :, None] +
          torch.sigmoid(x[:, :, 1])) / h
    aw = torch.tensor(anchors[0::2], dtype=torch.float32,
                      device=dev)[None, :, None, None]
    ah = torch.tensor(anchors[1::2], dtype=torch.float32,
                      device=dev)[None, :, None, None]
    input_h = downsample * h
    input_w = downsample * w
    bw = torch.exp(x[:, :, 2]) * aw / input_w
    bh = torch.exp(x[:, :, 3]) * ah / input_h
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    probs = torch.where(conf[:, :, None] > conf_thresh, probs, 0.0)

    im_h = img_size[:, 0].float()[:, None, None, None]
    im_w = img_size[:, 1].float()[:, None, None, None]
    x1 = (gx - bw * 0.5) * im_w
    y1 = (gy - bh * 0.5) * im_h
    x2 = (gx + bw * 0.5) * im_w
    y2 = (gy + bh * 0.5) * im_h
    if attrs.get("clip_bbox", True):
        x1 = torch.clamp(x1, torch.zeros_like(im_w), im_w - 1)
        y1 = torch.clamp(y1, torch.zeros_like(im_h), im_h - 1)
        x2 = torch.clamp(x2, torch.zeros_like(im_w), im_w - 1)
        y2 = torch.clamp(y2, torch.zeros_like(im_h), im_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)       # [n,an,h,w,4]
    boxes = boxes.permute(0, 2, 3, 1, 4).reshape(n, h * w * an, 4)
    scores = probs.permute(0, 3, 4, 1, 2).reshape(n, h * w * an, cls)
    return {"Boxes": [boxes], "Scores": [scores]}


@register_op("multiclass_nms", not_differentiable=True, grad_free=True)
def _multiclass_nms(ctx, ins, attrs):
    """Fixed-size NMS (reference: detection/multiclass_nms_op.cc returns a
    LoD tensor; here: Out [n, keep_top_k, 6] = (label, score, x1,y1,x2,y2)
    padded with label=-1, plus NmsRoisNum [n]). BBoxes [n,m,4] shared
    across classes, Scores [n, cls, m]. One NMS loop runs every image and
    class at once."""
    bboxes, scores = ins["BBoxes"][0], ins["Scores"][0]
    score_thresh = attrs.get("score_threshold", 0.01)
    nms_thresh = attrs.get("nms_threshold", 0.3)
    nms_top_k = int(attrs.get("nms_top_k", 64))
    keep_top_k = int(attrs.get("keep_top_k", 16))
    background = int(attrs.get("background_label", -1))
    normalized = bool(attrs.get("normalized", True))
    n, cls, m = scores.shape
    dev = scores.device
    k = min(nms_top_k, m)

    # top-k candidates of each class by score
    sc_k, idx = _top_k(scores, k)                        # [n, cls, k]
    bx = bboxes[torch.arange(n, device=dev)[:, None, None], idx]
    valid = sc_k > score_thresh
    keep = _nms_keep(bx, valid, nms_thresh, normalized)
    scs = sc_k * keep
    if 0 <= background < cls:
        # the background class never surfaces in detections
        is_bg = (torch.arange(cls, device=dev) == background)[None, :, None]
        scs = torch.where(is_bg, 0.0, scs)
    lb = torch.arange(cls, dtype=torch.float32, device=dev)[:, None] \
        .expand(cls, k).reshape(-1)
    sc = scs.reshape(n, -1)
    bx = bx.reshape(n, -1, 4)
    topk = min(keep_top_k, sc.shape[1])
    sc_f, idx = _top_k(sc, topk)
    out = torch.cat([lb[idx][..., None], sc_f[..., None], _rows(bx, idx)],
                    dim=-1)
    out = torch.where((sc_f > 0)[..., None], out, -1.0)
    if topk < keep_top_k:
        out = F.pad(out, (0, 0, 0, keep_top_k - topk), value=-1.0)
    counts = (sc_f > 0).sum(-1)
    return {"Out": [out], "NmsRoisNum": [counts.to(torch.int32)]}


@register_op("roi_align", no_grad_inputs={"ROIs", "RoisNum"})
def _roi_align(ctx, ins, attrs):
    """reference: detection/roi_align_op.cc — X [n,c,h,w], ROIs [r,4] in
    image coords; RoisNum [n] = rois per image (the reference's slot
    semantics), converted to a per-roi batch index. Without RoisNum all
    rois pool from image 0. Out [r, c, ph, pw]. Every roi's ph*ratio x
    pw*ratio bilinear samples are one gather of each corner."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    rois_num = ins.get("RoisNum", [None])[0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = attrs.get("spatial_scale", 1.0)
    ratio = int(attrs.get("sampling_ratio", -1))
    if ratio <= 0:
        ratio = 2
    n, c, h, w = x.shape
    r = rois.shape[0]
    dev = x.device
    bi = _batch_index(rois_num, n, r, dev)

    roi = rois * scale
    x1, y1, x2, y2 = roi[:, 0], roi[:, 1], roi[:, 2], roi[:, 3]
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    bin_w = rw / pw
    bin_h = rh / ph
    # sample points: ratio x ratio per bin, bilinear
    iy = (torch.arange(ph * ratio, device=dev) + 0.5) * \
        (bin_h / ratio)[:, None]
    ix = (torch.arange(pw * ratio, device=dev) + 0.5) * \
        (bin_w / ratio)[:, None]
    # clamp the SAMPLE coordinates (not just corner indices), or
    # out-of-image ROIs get weights outside [0,1] and extrapolate
    yy = torch.clamp(y1[:, None] + iy, 0.0, h - 1.0)       # [r, ph*ratio]
    xx = torch.clamp(x1[:, None] + ix, 0.0, w - 1.0)       # [r, pw*ratio]
    y0 = torch.clamp(torch.floor(yy), 0, h - 1)
    x0 = torch.clamp(torch.floor(xx), 0, w - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1).long()
    x1i = torch.clamp(x0 + 1, 0, w - 1).long()
    y0i = y0.long()
    x0i = x0.long()
    ly = (yy - y0)[:, None, :, None]
    lx = (xx - x0)[:, None, None, :]
    b = bi[:, None, None]

    def corner(yi, xi):                    # [r, c, ph*ratio, pw*ratio]
        return x[b, :, yi[:, :, None], xi[:, None, :]].permute(0, 3, 1, 2)

    val = (corner(y0i, x0i) * (1 - ly) * (1 - lx)
           + corner(y0i, x1i) * (1 - ly) * lx
           + corner(y1i, x0i) * ly * (1 - lx)
           + corner(y1i, x1i) * ly * lx)
    out = val.reshape(r, c, ph, ratio, pw, ratio).mean(dim=(3, 5))
    return {"Out": [out]}


@register_op("box_clip", not_differentiable=True, grad_free=True)
def _box_clip(ctx, ins, attrs):
    """reference: detection/box_clip_op.cc — clip boxes to image."""
    boxes, im_info = ins["Input"][0], ins["ImInfo"][0]
    h = im_info[:, 0][:, None] - 1
    w = im_info[:, 1][:, None] - 1
    zero = torch.zeros_like(h)
    x1 = torch.clamp(boxes[..., 0], zero, w)
    y1 = torch.clamp(boxes[..., 1], zero, h)
    x2 = torch.clamp(boxes[..., 2], zero, w)
    y2 = torch.clamp(boxes[..., 3], zero, h)
    return {"Output": [torch.stack([x1, y1, x2, y2], dim=-1)]}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@register_op("sigmoid_focal_loss", no_grad_inputs={"Label", "FgNum"})
def _sigmoid_focal_loss(ctx, ins, attrs):
    """reference: detection/sigmoid_focal_loss_op.h — X [N, C] logits,
    Label [N, 1] in {-1, 0, 1..C} (g==d+1 is positive for class d, -1 is
    ignored), FgNum [1] foreground count normalizer."""
    x = ins["X"][0]
    label = ins["Label"][0].reshape(-1).to(torch.int32)
    fg = ins["FgNum"][0].reshape(-1)[0].to(x.dtype)
    gamma = attrs.get("gamma", 2.0)
    alpha = attrs.get("alpha", 0.25)
    num_classes = x.shape[1]
    d = torch.arange(num_classes, device=x.device)[None, :]
    g = label[:, None]
    c_pos = (g == d + 1).to(x.dtype)
    c_neg = ((g != -1) & (g != d + 1)).to(x.dtype)
    fg = torch.clamp(fg, min=1.0)
    s_pos = alpha / fg
    s_neg = (1.0 - alpha) / fg
    p = torch.sigmoid(x)
    tiny = torch.finfo(x.dtype).tiny
    term_pos = torch.pow(1.0 - p, gamma) * torch.log(torch.clamp(p, min=tiny))
    # numerically-stable log(1-p) = -x*(x>=0) - log(1+exp(x-2x*(x>=0)))
    xpos = (x >= 0).to(x.dtype)
    term_neg = torch.pow(p, gamma) * (
        -x * xpos - torch.log1p(torch.exp(x - 2.0 * x * xpos)))
    out = -c_pos * term_pos * s_pos - c_neg * term_neg * s_neg
    return {"Out": [out]}


def _bce(logit, target):
    return torch.clamp(logit, min=0) - logit * target + \
        torch.log1p(torch.exp(-torch.abs(logit)))


def _centered_iou(cx1, cy1, w1, h1, cx2, cy2, w2, h2):
    ov_w = torch.minimum(cx1 + w1 / 2, cx2 + w2 / 2) - \
        torch.maximum(cx1 - w1 / 2, cx2 - w2 / 2)
    ov_h = torch.minimum(cy1 + h1 / 2, cy2 + h2 / 2) - \
        torch.maximum(cy1 - h1 / 2, cy2 - h2 / 2)
    inter = torch.where((ov_w < 0) | (ov_h < 0), 0.0, ov_w * ov_h)
    return inter / (w1 * h1 + w2 * h2 - inter + 1e-10)


@register_op("yolov3_loss",
             no_grad_inputs={"GTBox", "GTLabel", "GTScore"},
             non_diff_outputs={"ObjectnessMask", "GTMatchMask"})
def _yolov3_loss(ctx, ins, attrs):
    """reference: detection/yolov3_loss_op.h. X [n, mask*(5+cls), h, w],
    GTBox [n, b, 4] (cx,cy,w,h normalized), GTLabel [n, b], optional
    GTScore [n, b] (mixup). Loss [n]; ObjectnessMask [n, mask, h, w]
    (score>0 positive, 0 negative, -1 ignored); GTMatchMask [n, b].

    Matching (best-anchor argmax, ignore-thresh IoU) is combinatorial and
    treated as constant by the gradient, as in the reference's grad
    kernel; the loss terms are torch ops, so the generic vjp gives the
    reference gradients. Two matched gts of an image on one cell and
    anchor write that cell's score once, the later gt's (XLA's
    sequential scatter), so the mask does not depend on a GPU scatter's
    order."""
    x = ins["X"][0]
    gt_box = ins["GTBox"][0]
    gt_label = ins["GTLabel"][0].to(torch.int32)
    gt_score = ins.get("GTScore", [None])[0]
    anchors = [int(a) for a in attrs["anchors"]]
    anchor_mask = [int(a) for a in attrs["anchor_mask"]]
    class_num = int(attrs["class_num"])
    ignore_thresh = attrs.get("ignore_thresh", 0.7)
    downsample = int(attrs.get("downsample_ratio", 32))
    use_label_smooth = bool(attrs.get("use_label_smooth", True))

    dev = x.device
    n, _, h, w = x.shape
    an_num = len(anchors) // 2
    mask_num = len(anchor_mask)
    b = gt_box.shape[1]
    input_size = downsample * h
    if gt_score is None:
        gt_score = torch.ones((n, b), dtype=x.dtype, device=dev)

    label_pos, label_neg = 1.0, 0.0
    if use_label_smooth:
        delta = min(1.0 / class_num, 1.0 / 40)
        label_pos, label_neg = 1.0 - delta, delta

    x5 = x.reshape(n, mask_num, 5 + class_num, h, w)

    def fvec(vals):
        return torch.tensor(vals, dtype=x.dtype, device=dev)

    # predicted boxes (normalized cx,cy,w,h) for the ignore-thresh pass
    gi = torch.arange(w, device=dev)[None, None, None, :]
    gj = torch.arange(h, device=dev)[None, None, :, None]
    aw = fvec([anchors[2 * m] for m in anchor_mask])[None, :, None, None]
    ah = fvec([anchors[2 * m + 1] for m in anchor_mask])[None, :, None, None]
    px = (gi + torch.sigmoid(x5[:, :, 0])) / w
    py = (gj + torch.sigmoid(x5[:, :, 1])) / h
    pw = torch.exp(x5[:, :, 2]) * aw / input_size
    ph = torch.exp(x5[:, :, 3]) * ah / input_size

    gt_valid = (gt_box[..., 2] > 1e-6) & (gt_box[..., 3] > 1e-6)  # [n,b]

    # best IoU of each prediction against any valid gt: [n,mask,h,w]
    g = gt_box[:, None, None, None]                          # [n,1,1,1,b,4]
    iou_all = _centered_iou(
        px[..., None], py[..., None], pw[..., None], ph[..., None],
        g[..., 0], g[..., 1], g[..., 2], g[..., 3])
    iou_all = torch.where(gt_valid[:, None, None, None, :], iou_all, 0.0)
    best_iou = iou_all.amax(dim=-1)

    # gt -> best anchor (shape-only IoU over ALL anchors)
    all_aw = fvec(anchors[0::2]) / input_size
    all_ah = fvec(anchors[1::2]) / input_size
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    shape_iou = _centered_iou(
        zero, zero, gt_box[..., 2, None], gt_box[..., 3, None],
        zero, zero, all_aw[None, None, :], all_ah[None, None, :])  # [n,b,an]
    best_n = torch.argmax(shape_iou, dim=-1)                      # [n,b]
    lookup = [-1] * an_num
    for mi, m in enumerate(anchor_mask):
        lookup[m] = mi
    mask_lookup = torch.tensor(lookup, dtype=torch.int32, device=dev)
    match_mask = torch.where(gt_valid, mask_lookup[best_n],
                             -1).to(torch.int32)                  # [n,b]

    gi_t = torch.clamp((gt_box[..., 0] * w).to(torch.int32), 0, w - 1)
    gj_t = torch.clamp((gt_box[..., 1] * h).to(torch.int32), 0, h - 1)

    # objectness mask: score at matched cells, -1 at ignored, 0 else.
    # Unmatched gts write a disposable padding column (w), never a real
    # cell; of two matched gts on one (anchor, cell) only the later writes
    matched = match_mask >= 0
    mi = match_mask.clamp(min=0).long()
    cell = (mi * h + gj_t) * w + gi_t
    same = (cell[:, :, None] == cell[:, None, :]) & matched[:, None, :] & \
        torch.ones(b, b, dtype=torch.bool, device=dev).triu(1)
    col = torch.where(matched & ~same.any(-1), gi_t, w).long()
    obj_mask = torch.where(best_iou > ignore_thresh, -1.0, 0.0).to(x.dtype)
    padded = F.pad(obj_mask, (0, 1))
    padded = padded.index_put(
        (torch.arange(n, device=dev)[:, None].expand(n, b), mi,
         gj_t.long(), col), gt_score.to(x.dtype))
    obj_mask = padded[..., :w]

    # location + class loss gathered at matched cells
    ar = torch.arange(n, device=dev)[:, None]
    feats = x5[ar, mi, :, gj_t.long(), gi_t.long()]               # [n,b,5+cls]
    best = torch.clamp(torch.tensor(anchor_mask, device=dev)[mi],
                       0, an_num - 1)
    anw = fvec(anchors[0::2])[best]
    anh = fvec(anchors[1::2])[best]
    tx = gt_box[..., 0] * w - gi_t
    ty = gt_box[..., 1] * h - gj_t
    tw = torch.log(torch.clamp(gt_box[..., 2] * input_size / anw, min=1e-9))
    th = torch.log(torch.clamp(gt_box[..., 3] * input_size / anh, min=1e-9))
    scale = (2.0 - gt_box[..., 2] * gt_box[..., 3]) * gt_score
    loc = _bce(feats[..., 0], tx) * scale + _bce(feats[..., 1], ty) * scale + \
        torch.abs(feats[..., 2] - tw) * scale + \
        torch.abs(feats[..., 3] - th) * scale
    cls_t = torch.where(
        torch.arange(class_num, device=dev) == gt_label[..., None],
        label_pos, label_neg).to(x.dtype)
    cls_l = (_bce(feats[..., 5:], cls_t) * gt_score[..., None]).sum(-1)
    per_gt = torch.where(gt_valid & matched, loc + cls_l, 0.0)
    loss = per_gt.sum(dim=1)

    # objectness loss over all cells
    obj_logit = x5[:, :, 4]
    pos = obj_mask > 1e-5
    neg = (~pos) & (obj_mask > -0.5)
    obj_l = torch.where(pos, _bce(obj_logit, 1.0) * obj_mask, 0.0) + \
        torch.where(neg, _bce(obj_logit, 0.0), 0.0)
    loss = loss + obj_l.sum(dim=(1, 2, 3))
    return {"Loss": [loss], "ObjectnessMask": [obj_mask],
            "GTMatchMask": [match_mask]}


# ---------------------------------------------------------------------------
# priors / transforms
# ---------------------------------------------------------------------------

@register_op("density_prior_box", not_differentiable=True, grad_free=True)
def _density_prior_box(ctx, ins, attrs):
    """reference: detection/density_prior_box_op.h — dense grid of priors
    per (fixed_size, density) pair x fixed_ratios."""
    feat, image = ins["Input"][0], ins["Image"][0]
    dev = feat.device
    h, w = feat.shape[2], feat.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    fixed_sizes = [float(s) for s in attrs["fixed_sizes"]]
    fixed_ratios = [float(r) for r in attrs["fixed_ratios"]]
    densities = [int(d) for d in attrs["densities"]]
    step_w = attrs.get("step_w", 0.0) or img_w / w
    step_h = attrs.get("step_h", 0.0) or img_h / h
    offset = attrs.get("offset", 0.5)
    clip = attrs.get("clip", True)
    step_average = int((step_w + step_h) * 0.5)

    cx = (torch.arange(w, device=dev) + offset) * step_w      # [w]
    cy = (torch.arange(h, device=dev) + offset) * step_h      # [h]
    cx = cx[None, :].expand(h, w)
    cy = cy[:, None].expand(h, w)

    boxes = []
    for fs, density in zip(fixed_sizes, densities):
        shift = step_average // density
        for r in fixed_ratios:
            bw = fs * (r ** 0.5)
            bh = fs / (r ** 0.5)
            d0x = cx - step_average / 2.0 + shift / 2.0
            d0y = cy - step_average / 2.0 + shift / 2.0
            for di in range(density):
                for dj in range(density):
                    ccx = d0x + dj * shift
                    ccy = d0y + di * shift
                    boxes.append(torch.stack([
                        torch.clamp((ccx - bw / 2.0) / img_w, min=0.0),
                        torch.clamp((ccy - bh / 2.0) / img_h, min=0.0),
                        torch.clamp((ccx + bw / 2.0) / img_w, max=1.0),
                        torch.clamp((ccy + bh / 2.0) / img_h, max=1.0),
                    ], dim=-1))
    out = torch.stack(boxes, dim=2)                           # [h, w, np, 4]
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    var = torch.tensor(attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
                       dtype=torch.float32, device=dev)
    variances = var.expand(out.shape).contiguous()
    return {"Boxes": [out.float()], "Variances": [variances]}


@register_op("polygon_box_transform", not_differentiable=True,
             grad_free=True)
def _polygon_box_transform(ctx, ins, attrs):
    """reference: detection/polygon_box_transform_op.cc (EAST text
    detection geometry map: offsets -> absolute quad coords)."""
    x = ins["Input"][0]
    n, g, h, w = x.shape
    dev = x.device
    id_w = torch.arange(w, device=dev)[None, None, None, :].to(x.dtype)
    id_h = torch.arange(h, device=dev)[None, None, :, None].to(x.dtype)
    even = (torch.arange(g, device=dev) % 2 == 0)[None, :, None, None]
    return {"Output": [torch.where(even, id_w * 4 - x, id_h * 4 - x)]}


@register_op("box_decoder_and_assign",
             no_grad_inputs={"PriorBox", "PriorBoxVar", "BoxScore"})
def _box_decoder_and_assign(ctx, ins, attrs):
    """reference: detection/box_decoder_and_assign_op.h — per-class decode
    of [r, cls*4] deltas + pick the best non-background class's box."""
    prior = ins["PriorBox"][0]
    # the reference kernel reads only prior_box_var_data[0..3] — one
    # shared variance vector, not per-prior (box_decoder_and_assign_op.h)
    pvar = ins["PriorBoxVar"][0].reshape(-1)[:4]
    target = ins["TargetBox"][0]
    score = ins["BoxScore"][0]
    clip = attrs.get("box_clip", 4.135)
    r = target.shape[0]
    cls = score.shape[1]
    t = target.reshape(r, cls, 4)
    pw = prior[:, 2] - prior[:, 0] + 1
    phh = prior[:, 3] - prior[:, 1] + 1
    pcx = prior[:, 0] + pw / 2
    pcy = prior[:, 1] + phh / 2
    dw = torch.clamp(pvar[2] * t[..., 2], max=clip)
    dh = torch.clamp(pvar[3] * t[..., 3], max=clip)
    cx = pvar[0] * t[..., 0] * pw[:, None] + pcx[:, None]
    cy = pvar[1] * t[..., 1] * phh[:, None] + pcy[:, None]
    ww = torch.exp(dw) * pw[:, None]
    hh = torch.exp(dh) * phh[:, None]
    decode = torch.stack([cx - ww / 2, cy - hh / 2,
                          cx + ww / 2 - 1, cy + hh / 2 - 1], -1)  # [r,cls,4]
    # best non-background class (class 0 is background)
    if cls > 0:
        first = (torch.arange(cls, device=score.device) == 0)[None, :]
        sc = torch.where(first, -math.inf, score)
    else:
        sc = score
    best = torch.argmax(sc, dim=1)
    assign = torch.gather(decode, 1,
                          best[:, None, None].expand(r, 1, 4))[:, 0]
    has_fg = best > 0
    assign = torch.where(has_fg[:, None], assign, prior[:, :4])
    return {"DecodeBox": [decode.reshape(r, cls * 4)],
            "OutputAssignBox": [assign]}


# ---------------------------------------------------------------------------
# matching / target assignment
# ---------------------------------------------------------------------------

@register_op("bipartite_match", not_differentiable=True, grad_free=True)
def _bipartite_match(ctx, ins, attrs):
    """reference: detection/bipartite_match_op.cc — greedy global
    bipartite matching on DistMat [n, row, col] (batched dense form of
    the reference's LoD segments). Outputs ColToRowMatchIndices [n, col]
    (-1 = unmatched) and ColToRowMatchDist [n, col]. Each of the
    min(row, col) steps takes every image's largest free entry at once."""
    dist = ins["DistMat"][0]
    if dist.ndim == 2:
        dist = dist[None]
    match_type = attrs.get("match_type", "bipartite")
    thresh = attrs.get("dist_threshold", 0.5)
    n, row, col = dist.shape
    dev = dist.device
    iters = min(row, col)

    midx = torch.full((n, col), -1, dtype=torch.int32, device=dev)
    mdist = torch.zeros((n, col), dtype=dist.dtype, device=dev)
    row_free = torch.ones((n, row), dtype=torch.bool, device=dev)
    cols = torch.arange(col, device=dev)
    rows = torch.arange(row, device=dev)
    ar = torch.arange(n, device=dev)
    positive = dist > 1e-6
    for _ in range(0 if dist.is_meta else iters):
        masked = torch.where(row_free[:, :, None] & (midx == -1)[:, None, :]
                             & positive, dist, -1.0)
        flat = torch.argmax(masked.reshape(n, -1), dim=1)
        i, j = flat // col, flat % col
        val = masked[ar, i, j]
        ok = val > 0
        at_j = ok[:, None] & (cols[None, :] == j[:, None])
        midx = torch.where(at_j, i[:, None].to(torch.int32), midx)
        mdist = torch.where(at_j, val[:, None], mdist)
        row_free = row_free & ~(ok[:, None] & (rows[None, :] == i[:, None]))
    if match_type == "per_prediction":
        # unmatched cols take their argmax row if >= threshold
        best = torch.argmax(dist, dim=1)
        bestv = dist.amax(dim=1)
        extra = (midx == -1) & (bestv >= thresh) & (bestv > 1e-6)
        midx = torch.where(extra, best.to(torch.int32), midx)
        mdist = torch.where(extra, bestv, mdist)
    return {"ColToRowMatchIndices": [midx], "ColToRowMatchDist": [mdist]}


@register_op("target_assign",
             no_grad_inputs={"MatchIndices", "NegIndices"})
def _target_assign(ctx, ins, attrs):
    """reference: detection/target_assign_op.h. Dense redesign of the
    LoD form: X [n, b, K] per-image entity targets — or [n, b, P, K]
    per-entity-PER-PRIOR targets (the reference's P>1 case, used for
    encoded loc deltas where column m reads X[id, m, :]). MatchIndices
    [n, m] (-1 = mismatch), optional NegIndices [n, q] padded with -1.
    Out [n, m, K]; OutWeight [n, m, 1]. A -1 is clipped to 0 before it
    gathers (its row is then replaced) and scatters a weight of 0."""
    x = ins["X"][0]
    match = ins["MatchIndices"][0].long()
    neg = ins.get("NegIndices", [None])[0]
    mismatch_value = attrs.get("mismatch_value", 0)
    n, m = match.shape
    k = x.shape[-1]
    matched = match >= 0
    mc = match.clamp(min=0)
    # advanced indexing, not torch.gather: its gradient sums repeated
    # rows in a fixed order (gather's scatter-add does not on a GPU)
    if x.ndim == 4:
        # X [n, b, P, K]: out[i, j] = X[i, match[i,j], j % P]
        p = x.shape[2]
        cols = torch.arange(m, device=x.device) % p
        gathered = x[torch.arange(n, device=x.device)[:, None], mc,
                     cols[None, :]]
    else:
        gathered = _rows(x, mc)
    fill = torch.full((1, 1, k), float(mismatch_value), dtype=x.dtype,
                      device=x.device)
    out = torch.where(matched[:, :, None], gathered, fill)
    wt = matched.to(torch.float32)
    if neg is not None:
        # scatter weight 1 at negative indices (reference NegTargetAssign)
        neg = neg.long()
        wt = wt.scatter_add(1, neg.clamp(min=0),
                            (neg >= 0).to(torch.float32))
    return {"Out": [out], "OutWeight": [wt[:, :, None]]}


@register_op("mine_hard_examples", not_differentiable=True, grad_free=True)
def _mine_hard_examples(ctx, ins, attrs):
    """reference: detection/mine_hard_examples_op.cc (SSD OHEM). Fixed-
    size redesign: NegIndices [n, p] padded with -1 (the reference emits
    a LoD tensor), NegCount [n]; UpdatedMatchIndices [n, p]. Equal losses
    rank in prior order (a stable sort), which picks the negatives JAX
    picks where masked losses tie in bulk."""
    cls_loss = ins["ClsLoss"][0]
    match = ins["MatchIndices"][0].to(torch.int32)
    mdist = ins["MatchDist"][0]
    loc_loss = ins.get("LocLoss", [None])[0]
    mining = attrs.get("mining_type", "max_negative")
    ratio = attrs.get("neg_pos_ratio", 3.0)
    neg_thresh = attrs.get("neg_dist_threshold", 0.5)
    sample_size = int(attrs.get("sample_size", 0))
    n, p = match.shape
    dev = match.device
    loss = cls_loss
    if mining == "hard_example" and loc_loss is not None:
        loss = cls_loss + loc_loss
    if mining == "max_negative":
        eligible = (match == -1) & (mdist < neg_thresh)
    else:
        # hard_example mining ranks EVERY prior (positives included);
        # unselected positives are demoted below (reference
        # IsEligibleMining returns true for kHardExample)
        eligible = torch.ones_like(match, dtype=torch.bool)
    cand = torch.where(eligible, loss.reshape(n, p), -math.inf)
    order = _argsort(-cand, dim=1)                     # desc by loss
    rank = _inverse_perm(order)
    n_elig = eligible.sum(dim=1)
    if mining == "max_negative":
        num_pos = (match != -1).sum(dim=1)
        neg_sel = torch.minimum((num_pos * ratio).to(torch.int32), n_elig)
    else:
        neg_sel = torch.clamp(n_elig, max=sample_size)
    selected = eligible & (rank < neg_sel[:, None])
    # NegIndices: selected prior positions first (ascending), -1 padding
    ar = torch.arange(p, device=dev)[None, :]
    neg_sorted = torch.sort(torch.where(selected, ar, p), dim=1)[0]
    updated = match
    if mining == "hard_example":
        # positives not selected as hard examples get dropped, and
        # NegIndices only lists the selected NEGATIVES
        updated = torch.where((match > -1) & ~selected, -1,
                              match).to(torch.int32)
        sel_neg = selected & (match == -1)
        neg_sorted = torch.sort(torch.where(sel_neg, ar, p), dim=1)[0]
        neg_sel = sel_neg.sum(dim=1)
    neg_indices = torch.where(neg_sorted < p, neg_sorted, -1)
    return {"NegIndices": [neg_indices.to(torch.int32)],
            "NegCount": [neg_sel.to(torch.int32)],
            "UpdatedMatchIndices": [updated]}


def _sample_rank(mask, pri):
    """Rank of each candidate by priority (descending, stable), the
    others after them: JAX's argsort(argsort(-where(mask, pri, -inf)))."""
    return _inverse_perm(_argsort(-torch.where(mask, pri, -math.inf), -1))


@register_op("rpn_target_assign", not_differentiable=True, grad_free=True,
             stateful=True)
def _rpn_target_assign(ctx, ins, attrs):
    """reference: detection/rpn_target_assign_op.cc. Fixed-size redesign:
    per-anchor outputs instead of gathered variable-length index lists —
    TargetLabel [n, A] (1 fg / 0 bg / -1 ignore after subsampling),
    TargetBBox [n, A, 4] encoded regression targets, BBoxInsideWeight
    [n, A, 4] (1 on fg rows), ScoreIndex/LocationIndex [n, A] padded
    position lists (-1 padding) for API parity. With use_random the
    subsampling priorities are uniform draws of the run's generator."""
    anchor = ins["Anchor"][0]                    # [A, 4]
    gt_boxes = ins["GtBoxes"][0]                 # [n, g, 4] dense
    is_crowd = ins.get("IsCrowd", [None])[0]     # [n, g]
    im_info = ins["ImInfo"][0]                   # [n, 3]
    batch_per_im = int(attrs.get("rpn_batch_size_per_im", 256))
    straddle = attrs.get("rpn_straddle_thresh", 0.0)
    fg_frac = attrs.get("rpn_fg_fraction", 0.5)
    pos_ov = attrs.get("rpn_positive_overlap", 0.7)
    neg_ov = attrs.get("rpn_negative_overlap", 0.3)
    use_random = bool(attrs.get("use_random", True))
    a = anchor.shape[0]
    n = gt_boxes.shape[0]
    dev = anchor.device

    im_h, im_w = im_info[:, 0:1], im_info[:, 1:2]
    if straddle >= 0:
        inside = ((anchor[None, :, 0] >= -straddle) &
                  (anchor[None, :, 1] >= -straddle) &
                  (anchor[None, :, 2] < im_w + straddle) &
                  (anchor[None, :, 3] < im_h + straddle))    # [n, A]
    else:
        inside = torch.ones((n, a), dtype=torch.bool, device=dev)
    gt_valid = (gt_boxes[..., 2] > gt_boxes[..., 0]) & \
        (gt_boxes[..., 3] > gt_boxes[..., 1])
    if is_crowd is not None:
        gt_valid = gt_valid & (is_crowd == 0)
    iou = _iou_matrix(anchor[None], gt_boxes)                # [n, A, g]
    iou = torch.where(gt_valid[:, None, :], iou, 0.0)
    iou = torch.where(inside[:, :, None], iou, 0.0)
    a2g_max = iou.amax(dim=2)
    a2g_arg = torch.argmax(iou, dim=2)
    g2a_max = iou.amax(dim=1)
    is_best = (torch.abs(iou - g2a_max[:, None, :]) < 1e-5) & \
        (g2a_max[:, None, :] > 0)
    fg_mask = inside & ((a2g_max >= pos_ov) | is_best.any(dim=2))
    bg_mask = inside & ~fg_mask & (a2g_max < neg_ov)

    # subsample: random priority among candidates
    fg_target = int(batch_per_im * fg_frac)
    if use_random:
        pri = torch.rand((n, a), generator=ctx.rng(), device=dev)
    else:
        pri = -torch.arange(a, dtype=torch.float32, device=dev) \
            .expand(n, a)
    fg_keep = fg_mask & (_sample_rank(fg_mask, pri) < fg_target)
    n_fg = torch.clamp(fg_mask.sum(dim=1), max=fg_target)
    bg_target = batch_per_im - n_fg
    bg_keep = bg_mask & (_sample_rank(bg_mask, pri) < bg_target[:, None])

    labels = torch.where(fg_keep, 1, torch.where(bg_keep, 0, -1))
    # encoded regression targets vs matched gt (variance-free)
    tgt = _encode_vs(anchor[None], _rows(gt_boxes, a2g_arg))
    tgt = torch.where(fg_keep[:, :, None], tgt, 0.0)
    inw = fg_keep[:, :, None].to(anchor.dtype).expand(n, a, 4).contiguous()
    # padded position lists (fg first for LocationIndex; fg+bg for
    # ScoreIndex), -1 padding
    ar = torch.arange(a, device=dev)[None, :]
    loc_pos = torch.sort(torch.where(fg_keep, ar, a), dim=1)[0]
    sc_pos = torch.sort(torch.where(fg_keep | bg_keep, ar, a), dim=1)[0]
    loc_idx = torch.where(loc_pos < a, loc_pos, -1)
    sc_idx = torch.where(sc_pos < a, sc_pos, -1)
    return {"TargetLabel": [labels.to(torch.int32)], "TargetBBox": [tgt],
            "BBoxInsideWeight": [inw],
            "LocationIndex": [loc_idx.to(torch.int32)],
            "ScoreIndex": [sc_idx.to(torch.int32)]}


# ---------------------------------------------------------------------------
# RoI pooling / proposal generation (Faster R-CNN family)
# ---------------------------------------------------------------------------

# elements of one roi_pool chunk's masked [rois, ph, pw, c, h*w] block
_ROI_POOL_CHUNK = 1 << 26


def _roi_pool_bins(ins, attrs):
    """roi_pool's windows: (X, batch index [r], window mask [r, ph, pw,
    h, w], empty bins [r, ph, pw], rois a chunk)."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    rois_num = ins.get("RoisNum", [None])[0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = attrs.get("spatial_scale", 1.0)
    n, c, h, w = x.shape
    r = rois.shape[0]
    dev = x.device
    bi = _batch_index(rois_num, n, r, dev)

    rx1 = torch.round(rois[:, 0] * scale)
    ry1 = torch.round(rois[:, 1] * scale)
    rx2 = torch.round(rois[:, 2] * scale)
    ry2 = torch.round(rois[:, 3] * scale)
    rh = torch.clamp(ry2 - ry1 + 1, min=1.0)
    rw = torch.clamp(rx2 - rx1 + 1, min=1.0)
    bin_h = _true_div(rh, ph)[:, None]
    bin_w = _true_div(rw, pw)[:, None]
    p_h = torch.arange(ph, dtype=torch.float32, device=dev)[None, :]
    p_w = torch.arange(pw, dtype=torch.float32, device=dev)[None, :]
    hstart = torch.clamp(torch.floor(p_h * bin_h) + ry1[:, None], 0, h)
    hend = torch.clamp(torch.ceil((p_h + 1) * bin_h) + ry1[:, None], 0, h)
    wstart = torch.clamp(torch.floor(p_w * bin_w) + rx1[:, None], 0, w)
    wend = torch.clamp(torch.ceil((p_w + 1) * bin_w) + rx1[:, None], 0, w)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    in_h = (ys >= hstart[..., None]) & (ys < hend[..., None])   # [r, ph, h]
    in_w = (xs >= wstart[..., None]) & (xs < wend[..., None])   # [r, pw, w]
    m = in_h[:, :, None, :, None] & in_w[:, None, :, None, :]   # [r,ph,pw,h,w]
    empty = ~m.any(dim=(3, 4))                                  # [r, ph, pw]
    step = r if x.is_meta else max(1, _ROI_POOL_CHUNK // max(
        1, ph * pw * c * h * w))
    return x, bi, m, empty, step


def _roi_pool_grad(ctx, ins, attrs):
    """roi_pool's input gradient, JAX's max gradient: each bin's
    cotangent split evenly among the window's elements equal to its max,
    none from an empty bin. The generic vjp would keep every chunk's
    masked block for its backward (512 RoIs of (256, 50, 84) at 7x7:
    ~107 GB); this recomputes each chunk's block instead, and sums the
    chunks' rows into their images with a one-hot product (the same bits
    every run, unlike a scatter of floats)."""
    x, bi, m, empty, step = _roi_pool_bins(ins, attrs)
    out = ins["__out__Out"][0].permute(0, 2, 3, 1)     # [r, ph, pw, c]
    g = ins["Out@GRAD"][0].permute(0, 2, 3, 1)
    n, c, h, w = x.shape
    ar = torch.arange(n, device=x.device)
    dx = torch.zeros_like(x)
    for s in range(0, bi.shape[0], step):
        mm = m[s:s + step, :, :, None] & \
            ~empty[s:s + step, :, :, None, None, None]
        img = x[bi[s:s + step]][:, None, None]         # [k, 1, 1, c, h, w]
        hit = mm & (img == out[s:s + step, ..., None, None])
        cnt = hit.sum(dim=(4, 5), keepdim=True)
        share = g[s:s + step, ..., None, None] / torch.clamp(cnt, min=1)
        rows = torch.where(hit, share, 0.0).sum(dim=(1, 2))   # [k, c, h, w]
        onehot = (bi[s:s + step, None] == ar).to(x.dtype)   # [k, n]
        dx = dx + (onehot.t() @ rows.reshape(rows.shape[0], -1)).reshape(
            n, c, h, w)
    return {"X@GRAD": [dx]}


@register_op("roi_pool", no_grad_inputs={"ROIs", "RoisNum"},
             non_diff_outputs={"Argmax"}, grad_lower=_roi_pool_grad)
def _roi_pool(ctx, ins, attrs):
    """reference: operators/roi_pool_op.h — max pooling over RoI bins
    (integer-rounded bin edges, unlike roi_align's bilinear samples).
    X [n,c,h,w], ROIs [r,4], optional RoisNum [n]. Out [r,c,ph,pw].

    Each bin is JAX's masked max over the whole map, run over chunks of
    rois whose masked block stays under _ROI_POOL_CHUNK elements; its
    gradient is _roi_pool_grad."""
    x, bi, m, empty, step = _roi_pool_bins(ins, attrs)
    vals, args = [], []
    for s in range(0, bi.shape[0], step):
        mm = m[s:s + step, :, :, None]                # [k, ph, pw, 1, h, w]
        img = x[bi[s:s + step]][:, None, None]        # [k, 1, 1, c, h, w]
        masked = torch.where(mm, img, -math.inf).flatten(4)
        vals.append(masked.amax(dim=-1))
        args.append(torch.argmax(masked, dim=-1))
    mx = torch.cat(vals, 0) if len(vals) > 1 else vals[0]
    am = torch.cat(args, 0) if len(args) > 1 else args[0]
    e = empty[..., None]
    out = torch.where(e, 0.0, mx).permute(0, 3, 1, 2)
    argmax = torch.where(e, -1, am).permute(0, 3, 1, 2).to(torch.int64)
    return {"Out": [out], "Argmax": [argmax]}


@register_op("generate_proposals", not_differentiable=True, grad_free=True)
def _generate_proposals(ctx, ins, attrs):
    """reference: detection/generate_proposals_op.cc. Decode RPN deltas
    at every anchor, clip to image, filter small boxes, keep pre_nms_topN
    by score, NMS, keep post_nms_topN. Fixed-size redesign: RpnRois
    [n, post_nms_topN, 4] zero-padded + RpnRoisNum [n] (the reference
    emits LoD). Scores [n, A, 1] and BboxDeltas [n, A, 4] in the
    flattened-anchor layout with Anchors [A, 4], Variances [A, 4]. One
    NMS loop of pre_nms_topN steps runs every image."""
    scores = ins["Scores"][0]
    deltas = ins["BboxDeltas"][0]
    im_info = ins["ImInfo"][0]
    anchors = ins["Anchors"][0].reshape(-1, 4)
    variances = ins["Variances"][0].reshape(-1, 4)
    pre_n = int(attrs.get("pre_nms_topN", 6000))
    post_n = int(attrs.get("post_nms_topN", 1000))
    nms_thresh = attrs.get("nms_thresh", 0.5)
    min_size = attrs.get("min_size", 0.1)
    a = anchors.shape[0]
    n = scores.shape[0]
    sc = scores.reshape(n, a)
    dl = deltas.reshape(n, a, 4)
    k = min(pre_n, a)
    cap = _log_cap().to(scores.device)

    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    acx = anchors[:, 0] + aw / 2
    acy = anchors[:, 1] + ah / 2

    im_h, im_w, im_scale = im_info[:, 0:1], im_info[:, 1:2], im_info[:, 2:3]
    zero = torch.zeros_like(im_w)
    cx = variances[:, 0] * dl[..., 0] * aw + acx
    cy = variances[:, 1] * dl[..., 1] * ah + acy
    # the reference clips dw/dh at log(1000/16)
    bw = torch.exp(torch.minimum(variances[:, 2] * dl[..., 2], cap)) * aw
    bh = torch.exp(torch.minimum(variances[:, 3] * dl[..., 3], cap)) * ah
    x1 = torch.clamp(cx - bw / 2, zero, im_w - 1)
    y1 = torch.clamp(cy - bh / 2, zero, im_h - 1)
    x2 = torch.clamp(cx + bw / 2 - 1, zero, im_w - 1)
    y2 = torch.clamp(cy + bh / 2 - 1, zero, im_h - 1)
    ms = min_size * im_scale
    keep_size = ((x2 - x1 + 1) >= ms) & ((y2 - y1 + 1) >= ms)
    s = torch.where(keep_size, sc, -math.inf)
    top_s, idx = _top_k(s, k)
    boxes = _rows(torch.stack([x1, y1, x2, y2], -1), idx)      # [n, k, 4]
    valid = torch.isfinite(top_s)
    keep = _nms_keep(boxes, valid, nms_thresh, normalized=False)
    kept_s = torch.where(keep, top_s, -math.inf)
    fin_s, fin_i = _top_k(kept_s, min(post_n, k))
    out = _rows(boxes, fin_i)
    ok = torch.isfinite(fin_s)
    out = torch.where(ok[..., None], out, 0.0)
    probs = torch.where(ok, fin_s, 0.0)
    if post_n > k:
        out = F.pad(out, (0, 0, 0, post_n - k))
        probs = F.pad(probs, (0, post_n - k))
    return {"RpnRois": [out], "RpnRoiProbs": [probs[..., None]],
            "RpnRoisNum": [ok.sum(dim=1).to(torch.int32)]}


@register_op("distribute_fpn_proposals", not_differentiable=True,
             grad_free=True)
def _distribute_fpn_proposals(ctx, ins, attrs):
    """reference: detection/distribute_fpn_proposals_op.h. Fixed-size
    redesign: every level output is [r, 4] with that level's rois packed
    first (zero padding) + MultiLevelCounts [levels]; RestoreIndex maps
    each original roi to its row in the fixed concat of levels."""
    rois = ins["FpnRois"][0]
    min_level = int(attrs["min_level"])
    max_level = int(attrs["max_level"])
    refer_level = int(attrs["refer_level"])
    refer_scale = int(attrs["refer_scale"])
    num_level = max_level - min_level + 1
    r = rois.shape[0]
    dev = rois.device
    ar = torch.arange(r, device=dev)
    # optional valid counts (the fixed-size generate_proposals zero-pads):
    # padding rows must not be classified as tiny min_level rois.
    # RoisNum [n] covers the batched layout where FpnRois is the
    # reshape of [n, r/n, 4] — each image owns an equal r/n stride.
    rois_num = ins.get("RoisNum", [None])[0]
    if rois_num is not None:
        counts = rois_num.reshape(-1)
        stride = r // counts.shape[0]
        valid = (ar % stride) < counts[ar // stride]
    else:
        valid = torch.ones((r,), dtype=torch.bool, device=dev)
    w = torch.clamp(rois[:, 2] - rois[:, 0], min=0.0)
    h = torch.clamp(rois[:, 3] - rois[:, 1], min=0.0)
    area = (w + 1) * (h + 1)
    roi_scale = torch.sqrt(area)
    lvl = torch.floor(torch.log2(_true_div(roi_scale, refer_scale)
                                 + 1e-6)) + refer_level
    lvl = torch.clamp(lvl, min_level, max_level).to(torch.int32)
    lvl = torch.where(valid, lvl, -1)

    outs, counts = [], []
    restore = torch.zeros((r,), dtype=torch.int32, device=dev)
    for li in range(num_level):
        mask = lvl == (min_level + li)
        order = _argsort(~mask)                      # level rois first
        packed = torch.where((ar < mask.sum())[:, None], rois[order], 0.0)
        outs.append(packed)
        counts.append(mask.sum())
        rank = _inverse_perm(order)                  # row within level out
        restore = torch.where(mask, (li * r + rank).to(torch.int32),
                              restore)
    return {"MultiFpnRois": outs,
            "MultiLevelCounts": [torch.stack(counts).to(torch.int32)],
            "RestoreIndex": [restore[:, None]]}


@register_op("collect_fpn_proposals", not_differentiable=True,
             grad_free=True)
def _collect_fpn_proposals(ctx, ins, attrs):
    """reference: detection/collect_fpn_proposals_op.h — merge per-level
    (rois, scores), keep post_nms_topN by score. Fixed-size: FpnRois
    [topN, 4] zero-padded + RoisCount [1]."""
    rois_list = ins["MultiLevelRois"]
    score_list = ins["MultiLevelScores"]
    top_n = int(attrs.get("post_nms_topN", 100))
    # scores <= 0 mark PADDING rows (the fixed-size per-level outputs pad
    # with zeros); real proposals carry positive objectness
    # probabilities, as in the reference
    all_rois = torch.cat([x.reshape(-1, 4) for x in rois_list], 0)
    all_sc = torch.cat([s.reshape(-1) for s in score_list], 0)
    k = min(top_n, all_sc.shape[0])
    top_s, idx = _top_k(all_sc, k)
    out = all_rois[idx]
    ok = top_s > 0
    out = torch.where(ok[:, None], out, 0.0)
    if top_n > k:
        out = F.pad(out, (0, 0, 0, top_n - k))
        ok = F.pad(ok, (0, top_n - k))
    return {"FpnRois": [out],
            "RoisCount": [ok.sum().to(torch.int32)[None]]}


@register_op("retinanet_detection_output", not_differentiable=True,
             grad_free=True)
def _retinanet_detection_output(ctx, ins, attrs):
    """reference: detection/retinanet_detection_output_op.cc — decode
    per-FPN-level (bbox deltas, sigmoid scores, anchors), keep per-level
    nms_top_k candidates above score_threshold, then class-wise NMS and
    keep_top_k. Fixed-size: Out [n, keep_top_k, 6] padded with -1."""
    bboxes_l = ins["BBoxes"]            # each [n, Al, 4] deltas
    scores_l = ins["Scores"]            # each [n, Al, cls] (sigmoid probs)
    anchors_l = ins["Anchors"]          # each [Al, 4]
    im_info = ins["ImInfo"][0]
    score_thresh = attrs.get("score_threshold", 0.05)
    nms_top_k = int(attrs.get("nms_top_k", 1000))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    nms_thresh = attrs.get("nms_threshold", 0.3)
    n = bboxes_l[0].shape[0]
    cls = scores_l[0].shape[-1]
    cap = _log_cap().to(im_info.device)
    im_h, im_w = im_info[:, 0:1], im_info[:, 1:2]
    zero = torch.zeros_like(im_w)

    def decode_level(deltas, anchors):
        aw = anchors[:, 2] - anchors[:, 0] + 1
        ah = anchors[:, 3] - anchors[:, 1] + 1
        acx = anchors[:, 0] + aw / 2
        acy = anchors[:, 1] + ah / 2
        cx = deltas[..., 0] * aw + acx
        cy = deltas[..., 1] * ah + acy
        bw = torch.exp(torch.minimum(deltas[..., 2], cap)) * aw
        bh = torch.exp(torch.minimum(deltas[..., 3], cap)) * ah
        x1 = torch.clamp(cx - bw / 2, zero, im_w - 1)
        y1 = torch.clamp(cy - bh / 2, zero, im_h - 1)
        x2 = torch.clamp(cx + bw / 2 - 1, zero, im_w - 1)
        y2 = torch.clamp(cy + bh / 2 - 1, zero, im_h - 1)
        return torch.stack([x1, y1, x2, y2], -1)

    # per level (vectorized over the batch): decode + per-image top-k
    cand_boxes, cand_scores, cand_labels = [], [], []
    for deltas, sc, anch in zip(bboxes_l, scores_l, anchors_l):
        boxes = decode_level(deltas, anch)             # [n, Al, 4]
        flat = sc.reshape(n, -1)                       # [n, Al*cls]
        kk = min(nms_top_k, flat.shape[1])
        top_s, idx = _top_k(flat, kk)
        ai = idx // cls
        ci = idx % cls
        keep = top_s > score_thresh
        cand_boxes.append(_rows(boxes, ai))
        cand_scores.append(torch.where(keep, top_s, 0.0))
        cand_labels.append(ci)
    bx = torch.cat(cand_boxes, 1)                      # [n, L*kk, 4]
    sc = torch.cat(cand_scores, 1)
    lb = torch.cat(cand_labels, 1)

    # class-wise NMS: offset boxes per class so one NMS pass works
    # (standard batched-NMS trick)
    top = bx.reshape(n, -1).amax(dim=1)[:, None, None]
    offset = lb.to(bx.dtype)[..., None] * (top + 1.0)
    order = _argsort(-sc, dim=1)
    bx_s, sc_s, lb_s = _rows(bx, order), _rows(sc, order), _rows(lb, order)
    keep = _nms_keep(bx_s + _rows(offset, order), sc_s > 0, nms_thresh,
                     normalized=False)
    kept_s = torch.where(keep, sc_s, 0.0)
    kk = min(keep_top_k, kept_s.shape[1])
    fin_s, fin_i = _top_k(kept_s, kk)
    out = torch.cat([
        _rows(lb_s, fin_i)[..., None].to(bx.dtype) + 1.0,  # 1-based
        fin_s[..., None], _rows(bx_s, fin_i)], dim=-1)
    out = torch.where((fin_s > 0)[..., None], out, -1.0)
    if keep_top_k > kk:
        out = F.pad(out, (0, 0, 0, keep_top_k - kk), value=-1.0)
    return {"Out": [out],
            "NmsRoisNum": [(fin_s > 0).sum(dim=1).to(torch.int32)]}


@register_op("retinanet_target_assign", not_differentiable=True,
             grad_free=True)
def _retinanet_target_assign(ctx, ins, attrs):
    """reference: detection/retinanet_target_assign_op.cc. Dense redesign
    (same shape discipline as rpn_target_assign above): every anchor gets a
    class label — the matched gt label (which MUST be 1-based, 0 being the
    background code, the reference's convention) for IoU >=
    positive_overlap or best-match, 0 for IoU < negative_overlap, -1
    ignore in between (focal loss needs no subsampling);
    TargetBBox/BBoxInsideWeight are per-anchor encoded targets;
    ForegroundNumber [n, 1] counts fg anchors. PredScores/PredBBox pass
    the predictions through unchanged (the reference gathers; dense keeps
    all rows and the -1 labels mark ignores)."""
    anchor = ins["Anchor"][0]                    # [A, 4]
    gt_boxes = ins["GtBoxes"][0]                 # [n, g, 4]
    gt_labels = ins["GtLabels"][0]               # [n, g]
    is_crowd = ins.get("IsCrowd", [None])[0]
    pos_ov = attrs.get("positive_overlap", 0.5)
    neg_ov = attrs.get("negative_overlap", 0.4)
    a = anchor.shape[0]
    n = gt_boxes.shape[0]

    gt_valid = (gt_boxes[..., 2] > gt_boxes[..., 0]) & \
        (gt_boxes[..., 3] > gt_boxes[..., 1])
    if is_crowd is not None:
        gt_valid = gt_valid & (is_crowd.reshape(n, -1) == 0)
    iou = _iou_matrix(anchor[None], gt_boxes)              # [n, A, g]
    iou = torch.where(gt_valid[:, None, :], iou, 0.0)
    a2g_max = iou.amax(dim=2)
    a2g_arg = torch.argmax(iou, dim=2)
    g2a_max = iou.amax(dim=1)
    is_best = (torch.abs(iou - g2a_max[:, None, :]) < 1e-5) & \
        (g2a_max[:, None, :] > 0)
    fg = (a2g_max >= pos_ov) | is_best.any(dim=2)
    bg = ~fg & (a2g_max < neg_ov)
    cls = _rows(gt_labels.reshape(n, -1), a2g_arg).to(torch.int32)
    labels = torch.where(fg, cls, torch.where(bg, 0, -1)).to(torch.int32)
    tgt = _encode_vs(anchor[None], _rows(gt_boxes, a2g_arg))
    tgt = torch.where(fg[:, :, None], tgt, 0.0)
    inw = fg[:, :, None].to(anchor.dtype).expand(n, a, 4).contiguous()
    return {"PredScores": [ins["ClsLogits"][0]],
            "PredBBox": [ins["BBoxPred"][0]],
            "TargetLabel": [labels],
            "TargetBBox": [tgt],
            "BBoxInsideWeight": [inw],
            "ForegroundNumber": [fg.sum(dim=1, keepdim=True)
                                 .to(torch.int32)]}
