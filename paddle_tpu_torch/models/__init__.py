"""Model zoo of the PyTorch port: GPT-2 (inference, training, and KV-cache
decoding in `gpt_decode`), the BERT MLM pretrain step, ResNet
(resnet_cifar10, ResNet-50/101/152), VGG-16, LeNet-5, the NMT Transformer
(`transformer`), the book models (`book`) and DeepFM (`deepfm`, the
parameter-server CTR model)."""

from . import gpt  # noqa: F401
from . import bert  # noqa: F401
from . import resnet  # noqa: F401
from . import gpt_decode  # noqa: F401
from . import vgg  # noqa: F401
from . import lenet  # noqa: F401
from . import transformer  # noqa: F401
from . import book  # noqa: F401
from . import deepfm  # noqa: F401
