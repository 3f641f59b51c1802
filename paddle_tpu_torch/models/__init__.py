"""Model zoo of the PyTorch port: GPT-2 (inference and training), the
BERT MLM pretrain step and ResNet (resnet_cifar10, ResNet-50/101/152)."""

from . import gpt  # noqa: F401
from . import bert  # noqa: F401
from . import resnet  # noqa: F401
