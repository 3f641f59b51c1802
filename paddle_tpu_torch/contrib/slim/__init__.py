"""Model compression toolkit (reference: contrib/slim/: quantization,
prune, distillation, light-NAS + SA searcher). Port of
`paddle_tpu/contrib/slim/`."""

from . import quantization  # noqa: F401
from . import prune  # noqa: F401
from . import distillation  # noqa: F401
from . import nas  # noqa: F401
from .quantization import (QuantizationTransformPass,  # noqa: F401
                           QuantizationFreezePass, PostTrainingQuantization)
from .prune import Pruner, apply_masks  # noqa: F401
from .nas import (SAController, SearchSpace, LightNASSearcher,  # noqa: F401
                  ControllerServer, SearchAgent, flops, latency_estimate)
