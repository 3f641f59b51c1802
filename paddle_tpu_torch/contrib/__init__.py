"""contrib of the PyTorch port: the bf16 AMP rewrite and the CTR metric
bundle layer (the rest of the JAX package's contrib comes with later
slices)."""

from . import mixed_precision  # noqa: F401
from . import layers  # noqa: F401
