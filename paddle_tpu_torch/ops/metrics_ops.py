"""In-graph streaming metric ops (reference: operators/metrics/): auc,
precision_recall, and the ctr_metric_bundle accumulators.

Port of `paddle_tpu/ops/metrics_ops.py`. The accumulators are persistable
scope vars that each step updates, the reference's StatPos/StatNeg/
StatesInfo model (metrics/auc_op.h:40, the outputs write the persistable
stat inputs' names): a run's outputs are the scope's new values. auc and
precision_recall are update ops (`is_optimizer_op`), so where the executor
donates their state auc adds the batch histogram in place; each update is
a few scatter-adds and cumsums on the executor's device, with no host read.
"""

import torch

from ..framework.registry import register_op


def _hist(bins, weights, buckets):
    return torch.zeros(buckets, dtype=weights.dtype,
                       device=weights.device).index_add_(0, bins, weights)


@register_op("auc", not_differentiable=True, grad_free=True,
             is_optimizer_op=True)
def _auc(ctx, ins, attrs):
    """reference: metrics/auc_op.h: bucketized ROC (or PR) AUC.

    Predict [n, 1 or 2] (last column = positive-class prob), Label [n, 1]
    int; StatPos/StatNeg int64 accumulators:
      slide_steps == 0: [1, num_thresholds+1] running totals;
      slide_steps == k: [k, num_thresholds+1] ring of the last k batch
      histograms (the reference keeps the same k blocks flattened).
    """
    pred = ins["Predict"][0]
    label = ins["Label"][0].reshape(-1)
    stat_pos = ins["StatPos"][0]
    stat_neg = ins["StatNeg"][0]
    num_thresholds = int(attrs.get("num_thresholds", 4095))
    slide_steps = int(attrs.get("slide_steps", 0))
    buckets = num_thresholds + 1

    p = pred.reshape(pred.shape[0], -1)[:, -1].float()
    bins = (p * num_thresholds).to(torch.int32).clamp(
        0, num_thresholds).long()
    is_pos = (label != 0).to(stat_pos.dtype)
    pos_hist = _hist(bins, is_pos, buckets)
    neg_hist = _hist(bins, (1 - is_pos).to(stat_neg.dtype), buckets)

    if slide_steps == 0:
        if "StatPos" in ctx.inplace and "StatNeg" in ctx.inplace:
            pos_out = stat_pos.view(-1).add_(pos_hist).view(stat_pos.shape)
            neg_out = stat_neg.view(-1).add_(neg_hist).view(stat_neg.shape)
        else:
            pos_out = (stat_pos.reshape(-1) + pos_hist).reshape(
                stat_pos.shape)
            neg_out = (stat_neg.reshape(-1) + neg_hist).reshape(
                stat_neg.shape)
        eff_pos, eff_neg = pos_out.reshape(-1), neg_out.reshape(-1)
    else:
        ring_p = stat_pos.reshape(slide_steps, buckets)
        ring_n = stat_neg.reshape(slide_steps, buckets)
        ring_p = torch.cat([ring_p[1:], pos_hist[None]], dim=0)
        ring_n = torch.cat([ring_n[1:], neg_hist[None]], dim=0)
        eff_pos = ring_p.sum(dim=0)
        eff_neg = ring_n.sum(dim=0)
        pos_out = ring_p.reshape(stat_pos.shape)
        neg_out = ring_n.reshape(stat_neg.shape)

    # trapezoid sweep from the highest threshold down (auc_op.h calcAuc):
    # cumulative TP/FP counts are reversed cumsums over the buckets
    acc = torch.float64 if eff_pos.dtype == torch.int64 else torch.float32
    pos_rev = eff_pos.flip(0).to(acc)
    neg_rev = eff_neg.flip(0).to(acc)
    pc = torch.cumsum(pos_rev, 0)
    nc = torch.cumsum(neg_rev, 0)
    pc_prev = pc - pos_rev
    nc_prev = nc - neg_rev
    area = torch.sum(torch.abs(nc - nc_prev) * (pc + pc_prev) / 2.0)
    tot_pos, tot_neg = pc[-1], nc[-1]
    auc = torch.where((tot_pos > 0) & (tot_neg > 0),
                      area / torch.clamp(tot_pos * tot_neg, min=1.0), 0.0)
    # the reference emits double; f32 here, the var's declared type (and
    # JAX's without x64)
    return {"AUC": [auc.float()],
            "StatPosOut": [pos_out], "StatNegOut": [neg_out]}


def _pr_metrics(states):
    """[C, 4] TP/FP/TN/FN -> the 6 metrics (precision_recall_op.h
    ComputeMetrics): macro P/R/F1 then micro P/R/F1."""
    tp, fp, fn = states[:, 0], states[:, 1], states[:, 3]

    def prec(t, f):
        return torch.where((t > 0) | (f > 0),
                           t / torch.clamp(t + f, min=1e-30), 1.0)

    def f1(p, r):
        return torch.where((p + r) > 0,
                           2 * p * r / torch.clamp(p + r, min=1e-30), 0.0)

    macro_p = torch.mean(prec(tp, fp))
    macro_r = torch.mean(prec(tp, fn))
    micro_p = prec(tp.sum(), fp.sum())
    micro_r = prec(tp.sum(), fn.sum())
    return torch.stack([macro_p, macro_r, f1(macro_p, macro_r),
                        micro_p, micro_r, f1(micro_p, micro_r)])


@register_op("precision_recall", not_differentiable=True, grad_free=True,
             is_optimizer_op=True)
def _precision_recall(ctx, ins, attrs):
    """reference: metrics/precision_recall_op.h: per-class TP/FP/TN/FN
    accumulation + macro/micro precision, recall, F1. Indices [n, 1] =
    predicted class, Labels [n, 1], optional Weights [n, 1], StatesInfo
    [C, 4] persistable accumulator."""
    ids = ins["Indices"][0].reshape(-1).long()
    labels = ins["Labels"][0].reshape(-1).long()
    c = int(attrs["class_number"])
    w = (ins["Weights"][0].reshape(-1).float() if "Weights" in ins
         else torch.ones(ids.shape, dtype=torch.float32, device=ids.device))
    match = (ids == labels).float()
    wm = w * match
    wx = w * (1.0 - match)
    tp = _hist(ids, wm, c)
    fp = _hist(ids, wx, c)
    fn = _hist(labels, wx, c)
    # TN: every sample credits all classes, debited at its predicted class
    # and (on mismatch) at its label class
    tn = torch.sum(w) - _hist(ids, w, c) - _hist(labels, wx, c)
    batch_states = torch.stack([tp, fp, tn, fn], dim=1)

    accum = batch_states
    if "StatesInfo" in ins and ins["StatesInfo"]:
        accum = accum + ins["StatesInfo"][0].float()
    return {"BatchMetrics": [_pr_metrics(batch_states)],
            "AccumMetrics": [_pr_metrics(accum)],
            "AccumStatesInfo": [accum]}


@register_op("ctr_metric_bundle", not_differentiable=True, grad_free=True)
def _ctr_metric_bundle(ctx, ins, attrs):
    """Streaming CTR stats (reference: contrib/layers/metric_op.py
    ctr_metric_bundle composition): accumulate sum((p-y)^2), sum(|p-y|),
    sum(p) and the q value, following the JAX op: local_q += sum(p * y)."""
    p = ins["X"][0].reshape(-1).float()
    y = ins["Label"][0].reshape(-1).float()
    err = p - y
    return {"SqrErr": [ins["SqrErrIn"][0] + torch.sum(err * err).reshape(1)],
            "AbsErr": [ins["AbsErrIn"][0]
                       + torch.sum(torch.abs(err)).reshape(1)],
            "Prob": [ins["ProbIn"][0] + torch.sum(p).reshape(1)],
            "Q": [ins["QIn"][0] + torch.sum(p * y).reshape(1)]}
