"""contrib of the PyTorch port: the bf16 AMP rewrite (the rest of the JAX
package's contrib comes with later slices)."""

from . import mixed_precision  # noqa: F401
