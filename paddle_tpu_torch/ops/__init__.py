"""Op lowering rules of the PyTorch port (importing registers them)."""

from . import math_ops  # noqa: F401
from . import activation_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import attention_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import misc_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import extra_ops  # noqa: F401
from . import control_flow_ops  # noqa: F401
from . import lod_array_ops  # noqa: F401
from . import rnn_ops  # noqa: F401
from . import io_dist_ops  # noqa: F401
from . import reader_ops  # noqa: F401
from . import loss_ops  # noqa: F401
from . import metrics_ops  # noqa: F401
