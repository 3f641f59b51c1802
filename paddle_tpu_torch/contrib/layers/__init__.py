"""contrib layers (reference: python/paddle/fluid/contrib/layers/): the
CTR metric bundle. `rnn_impl` (basic_gru/basic_lstm) and
`fused_elemwise_activation` of the JAX package's contrib layers come with
ROADMAP A.12."""

from .metric_op import ctr_metric_bundle  # noqa: F401

__all__ = ["ctr_metric_bundle"]
