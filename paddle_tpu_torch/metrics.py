"""Host-side metric accumulators (reference: python/paddle/fluid/metrics.py,
889 LoC: MetricBase, CompositeMetric, Precision, Recall, Accuracy, Auc...).
These accumulate numpy fetches across batches; in-graph per-batch metrics
come from the metric ops (accuracy op, ops/nn_ops.py; auc and
precision_recall, ops/metrics_ops.py). A copy of `paddle_tpu/metrics.py`
(numpy only); `DetectionMAP` builds over the detection_map op, which comes
with the detection ops (ROADMAP A.7, the long tail), and raises until
then."""

from __future__ import annotations

import numpy as np

__all__ = ["MetricBase", "CompositeMetric", "Accuracy", "Precision",
           "Recall", "ChunkEvaluator", "Auc", "EditDistance",
           "DetectionMAP"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or type(self).__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *a, **kw):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    """Accumulates the in-graph accuracy op's (value, weight) pairs."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no batches accumulated")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.asarray(preds).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        pred_pos = preds > 0.5
        self.tp += int(np.sum(pred_pos & (labels == 1)))
        self.fp += int(np.sum(pred_pos & (labels == 0)))

    def eval(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.asarray(preds).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        pred_pos = preds > 0.5
        self.tp += int(np.sum(pred_pos & (labels == 1)))
        self.fn += int(np.sum(~pred_pos & (labels == 1)))

    def eval(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


class Auc(MetricBase):
    """Histogram-bucketed ROC AUC (reference metrics.py Auc)."""

    def __init__(self, name=None, num_thresholds=4095):
        super().__init__(name)
        self._n = num_thresholds
        self.reset()

    def reset(self):
        self._pos = np.zeros(self._n + 1, np.int64)
        self._neg = np.zeros(self._n + 1, np.int64)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        idx = np.clip((preds * self._n).astype(np.int64), 0, self._n)
        np.add.at(self._pos, idx[labels == 1], 1)
        np.add.at(self._neg, idx[labels == 0], 1)

    def eval(self):
        tot_pos = self._pos.sum()
        tot_neg = self._neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # walk thresholds high->low accumulating TPR/FPR trapezoids
        tp = np.cumsum(self._pos[::-1])
        fp = np.cumsum(self._neg[::-1])
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        return float(np.trapezoid(tpr, fpr))


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer = 0
        self.num_label = 0
        self.num_correct = 0

    def update(self, num_infer, num_label, num_correct):
        self.num_infer += int(num_infer)
        self.num_label += int(num_label)
        self.num_correct += int(num_correct)

    def eval(self):
        precision = self.num_correct / self.num_infer if self.num_infer \
            else 0.0
        recall = self.num_correct / self.num_label if self.num_label else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        return precision, recall, f1


class EditDistance(MetricBase):
    """Accumulate edit distances over sequence pairs (reference:
    fluid/metrics.py:492). update() takes a (batch, 1) distances array and
    the pair count; eval() returns (avg_distance, wrong_instance_ratio)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        if not np.issubdtype(distances.dtype, np.number):
            raise ValueError("'distances' must be a numeric ndarray")
        if not isinstance(seq_num, (int, float, np.integer, np.floating)):
            raise ValueError("'seq_num' must be a number")
        self.seq_num += seq_num
        self.instance_error += seq_num - int(np.sum(distances == 0))
        self.total_distance += float(np.sum(distances))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError(
                "There is no data in EditDistance Metric. Please check "
                "layers.edit_distance output has been added to EditDistance.")
        avg_distance = self.total_distance / self.seq_num
        wrong_instance_ratio = self.instance_error / self.seq_num
        return avg_distance, wrong_instance_ratio


class DetectionMAP:
    """Graph-builder mAP evaluator (reference: fluid/metrics.py:695
    DetectionMAP) over the streaming detection_map op. Dense shapes:
    input [n, D, 6] (label, score, box), gt_label [n, G, 1],
    gt_box [n, G, 4], gt_difficult [n, G, 1] or None.

    Appends TWO detection_map ops to the current program: a stateless one
    (current-batch mAP) and the accumulating one (persistable bucketized
    TP/FP state — ops/detection_extra_ops.py). get_map_var() returns
    (cur_map, accum_map); reset(executor) zeroes the accumulators."""

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0,
                 overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral"):
        raise NotImplementedError(
            "DetectionMAP builds over the detection_map op, which is not "
            "ported to paddle_tpu_torch yet (ROADMAP A.7, the detection "
            "ops)")

    def get_map_var(self):
        return self.cur_map, self.accum_map

    def reset(self, executor, reset_program=None, scope=None):
        """Zero the accumulators (reference resets via a fill program).
        Pass `scope` when eval runs with an explicit Executor.run(scope=)
        instead of scope_guard."""
        import torch
        from .framework.executor import global_scope
        scope = scope or global_scope()
        for n in self._state_names:
            v = scope.find_var(n)
            if v is not None:
                scope.set_var(n, torch.zeros_like(v))
