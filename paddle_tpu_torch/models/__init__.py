"""Model zoo of the PyTorch port: GPT-2 (inference and training) and the
BERT MLM pretrain step."""

from . import gpt  # noqa: F401
from . import bert  # noqa: F401
