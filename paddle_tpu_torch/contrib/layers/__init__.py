"""contrib layers (reference: python/paddle/fluid/contrib/layers/): the
fused elementwise-activation layer and the CTR metric bundle.
`rnn_impl` (basic_gru/basic_lstm) of the JAX package's contrib layers
comes with ROADMAP A.12."""

from .nn import fused_elemwise_activation  # noqa: F401
from .metric_op import ctr_metric_bundle  # noqa: F401

__all__ = ["fused_elemwise_activation", "ctr_metric_bundle"]
