"""DeepFM CTR model (the BASELINE.json 'DeepFM / wide&deep CTR' config;
reference-era CTR models ran on the pslib parameter server with sparse
embeddings — here the same shape runs on the pskv PS path via
is_sparse=True embeddings).

Copy of `paddle_tpu/models/deepfm.py` (it imports no JAX): the same ops,
names and order, so a program either package builds is op for op the
other's and parameters carry across by name.

Inputs: `num_fields` sparse id slots (one id per field, a shared id
space of `sparse_feature_dim`) + optional dense features. Output:
sigmoid CTR probability; loss = log loss.

FM second-order term uses the sum-square trick
(0.5 * ((sum_i v_i)^2 - sum_i v_i^2)) — one reduction instead of the
O(F^2) pair sum.
"""

from __future__ import annotations

from .. import layers
from ..framework.layer_helper import ParamAttr


def deepfm(num_fields: int = 26, sparse_feature_dim: int = 10000,
           embedding_size: int = 10, dense_dim: int = 13,
           layer_sizes=(400, 400, 400), is_sparse: bool = True):
    feat_ids = layers.data("feat_ids", [num_fields], dtype="int64")
    label = layers.data("label", [1], dtype="float32")
    feed = ["feat_ids", "label"]

    # first-order: per-id scalar weight (its own 1-dim embedding table)
    w1 = layers.embedding(feat_ids, size=[sparse_feature_dim, 1],
                          is_sparse=is_sparse,
                          param_attr=ParamAttr(name="fm_w1"))
    first_order = layers.reduce_sum(layers.squeeze(w1, axes=[2]), dim=1,
                                    keep_dim=True)

    # second-order: shared factor embeddings
    emb = layers.embedding(feat_ids, size=[sparse_feature_dim,
                                           embedding_size],
                           is_sparse=is_sparse,
                           param_attr=ParamAttr(name="fm_v"))   # [b,F,k]
    sum_v = layers.reduce_sum(emb, dim=1)                        # [b,k]
    sum_v_sq = sum_v * sum_v
    sq_v_sum = layers.reduce_sum(emb * emb, dim=1)
    second_order = layers.scale(
        layers.reduce_sum(sum_v_sq - sq_v_sum, dim=1, keep_dim=True),
        scale=0.5)

    # deep part over the concatenated field embeddings
    deep = layers.reshape(emb, [0, num_fields * embedding_size])
    if dense_dim > 0:
        dense = layers.data("dense_feats", [dense_dim], dtype="float32")
        feed.insert(1, "dense_feats")
        deep = layers.concat([deep, dense], axis=1)
    for width in layer_sizes:
        deep = layers.fc(deep, width, act="relu")
    deep_out = layers.fc(deep, 1)

    logit = first_order + second_order + deep_out
    prob = layers.sigmoid(logit)
    loss = layers.mean(
        layers.log_loss(prob, label))
    auc_in = layers.concat([1.0 - prob, prob], axis=1)
    return {"feed": feed, "loss": loss, "prob": prob, "auc_input": auc_in,
            "label": label}
