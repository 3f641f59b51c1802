"""contrib metric layers (reference:
python/paddle/fluid/contrib/layers/metric_op.py:30 ctr_metric_bundle).

Streams CTR quality stats into persistable accumulators, like the in-graph
auc/precision_recall ops (ops/metrics_ops.py): local_sqrerr, local_abserr,
local_prob, local_q — divide by total instance count (allreduced first in a
distributed job) for RMSE/MAE/predicted-CTR/q. A copy of
`paddle_tpu/contrib/layers/metric_op.py`."""

from __future__ import annotations

from ...framework.layer_helper import LayerHelper

__all__ = ["ctr_metric_bundle"]


def ctr_metric_bundle(input, label):
    if tuple(input.shape) != tuple(label.shape):
        raise AssertionError("input and label shapes must match")
    helper = LayerHelper("ctr_metric_bundle")
    sqrerr = helper.create_global_state_var("ctr_sqrerr", (1,), "float32")
    abserr = helper.create_global_state_var("ctr_abserr", (1,), "float32")
    prob = helper.create_global_state_var("ctr_prob", (1,), "float32")
    q = helper.create_global_state_var("ctr_q", (1,), "float32")
    helper.append_op("ctr_metric_bundle",
                     {"X": [input.name], "Label": [label.name],
                      "SqrErrIn": [sqrerr.name], "AbsErrIn": [abserr.name],
                      "ProbIn": [prob.name], "QIn": [q.name]},
                     {"SqrErr": [sqrerr.name], "AbsErr": [abserr.name],
                      "Prob": [prob.name], "Q": [q.name]}, {})
    return sqrerr, abserr, prob, q
