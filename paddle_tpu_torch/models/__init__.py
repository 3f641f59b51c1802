"""Model zoo of the PyTorch port (GPT-2 inference in this slice)."""

from . import gpt  # noqa: F401
