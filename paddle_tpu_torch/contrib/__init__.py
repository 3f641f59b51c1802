"""contrib of the PyTorch port: the bf16 AMP rewrite, the model
compression toolkit (`slim`: quantization, pruning, distillation,
light-NAS), the contrib layers (`fused_elemwise_activation`, the CTR
metric bundle) and the program statistics (`summary`, `memory_usage`,
`op_freq_statistic`). The JAX package's `extend_optimizer`, `decoder`,
`reader` and `layers.rnn_impl` come with ROADMAP A.12."""

from . import mixed_precision  # noqa: F401
from . import slim  # noqa: F401
from . import layers  # noqa: F401
from .layers import fused_elemwise_activation, ctr_metric_bundle  # noqa: F401
from .memory_usage_calc import memory_usage  # noqa: F401
from .model_stat import summary  # noqa: F401
from .op_frequence import op_freq_statistic  # noqa: F401
