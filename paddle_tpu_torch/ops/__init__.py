"""Op lowering rules of the PyTorch port (importing registers them)."""

from . import math_ops  # noqa: F401
from . import activation_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import attention_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
