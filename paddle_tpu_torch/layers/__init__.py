"""Layers DSL of the PyTorch port (the GPT, BERT and ResNet subset)."""

from .math import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

from . import math  # noqa: F401
from . import nn  # noqa: F401
from . import tensor  # noqa: F401
