"""Layers DSL of the PyTorch port: the core layers of `layers/{nn,tensor,
math}.py` (every name of the JAX package's three files), control flow
(`layers.control_flow`: While, cond, Switch, StaticRNN, DynamicRNN,
IfElse), the sequence and RNN layers (`layers.sequence`, `layers.rnn`),
the LR schedules (`layers.learning_rate_scheduler`), the decoders
(`layers.decode`), `layers.distributions` and the detection layers
(`layers.detection`) and the long-tail layers of `layers.nn_extra`,
star-exported last as JAX's are (so `layers.resize_bilinear` and the
other names it shares with `layers.nn` are nn_extra's)."""

from .math import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .nn_extra import *  # noqa: F401,F403

from . import math  # noqa: F401
from . import nn  # noqa: F401
from . import tensor  # noqa: F401
from . import sequence  # noqa: F401
from . import learning_rate_scheduler  # noqa: F401
from . import control_flow  # noqa: F401
from . import rnn  # noqa: F401
from . import decode  # noqa: F401
from . import distributions  # noqa: F401
from . import detection  # noqa: F401
from . import nn_extra  # noqa: F401
