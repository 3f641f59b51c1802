"""ResNet builders (reference: tests/book test_image_classification
resnet_cifar10, and the dist-test workhorse dist_se_resnext.py; ImageNet
ResNet-50 is the classic throughput benchmark model).

Copied from `paddle_tpu/models/resnet.py`: pure DSL, so the programs match
the JAX package's op for op. NCHW layout, conv+bn+relu blocks; the convs
run on cuDNN and batch_norm/relu as torch ops, with no hand-written fused
op, as in the JAX package (the conv+BN spike,
`paddle_tpu_torch/tools/spike_conv_bn.py`, is its own entry point)."""

from __future__ import annotations

from .. import layers


# data_format threads through every block; NCHW is the fluid-compatible
# default, NHWC permutes around each conv
def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  data_format="NCHW"):
    conv = layers.conv2d(input, ch_out, filter_size, stride=stride,
                         padding=padding, bias_attr=False,
                         data_format=data_format)
    return layers.batch_norm(conv, act=act,
                             data_layout=data_format)


def shortcut(input, ch_in, ch_out, stride, data_format="NCHW"):
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             data_format=data_format)
    return input


def basicblock(input, ch_in, ch_out, stride, data_format="NCHW"):
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None,
                          data_format=data_format)
    short = shortcut(input, ch_in, ch_out, stride, data_format)
    return layers.relu(short + conv2)


def bottleneck(input, ch_in, ch_out, stride, data_format="NCHW"):
    conv1 = conv_bn_layer(input, ch_out, 1, 1, 0, data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, stride, 1,
                          data_format=data_format)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          data_format=data_format)
    short = shortcut(input, ch_in, ch_out * 4, stride, data_format)
    return layers.relu(short + conv3)


def _layer_stack(block, input, ch_in, ch_out, count, stride,
                 data_format="NCHW"):
    x = block(input, ch_in, ch_out, stride, data_format)
    ch_in = ch_out * (4 if block is bottleneck else 1)
    for _ in range(1, count):
        x = block(x, ch_in, ch_out, 1, data_format)
    return x


def resnet_cifar10(input, depth: int = 20, class_num: int = 10):
    """reference: tests/book/test_image_classification.py resnet_cifar10 —
    6n+2 layers on 32x32 inputs."""
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    x = conv_bn_layer(input, 16, 3, 1, 1)
    x = _layer_stack(basicblock, x, 16, 16, n, 1)
    x = _layer_stack(basicblock, x, 16, 32, n, 2)
    x = _layer_stack(basicblock, x, 32, 64, n, 2)
    x = layers.pool2d(x, 8, "avg", 1)
    return layers.fc(x, class_num)


_RESNET_CFG = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def resnet(input, depth: int = 50, class_num: int = 1000,
           data_format: str = "NCHW"):
    """ImageNet-style ResNet-50/101/152 (bottleneck blocks, 224x224).
    data_format NHWC expects input shaped [n, h, w, 3]."""
    c = _RESNET_CFG[depth]
    x = conv_bn_layer(input, 64, 7, 2, 3, data_format=data_format)
    x = layers.pool2d(x, 3, "max", 2, pool_padding=1,
                      data_format=data_format)
    x = _layer_stack(bottleneck, x, 64, 64, c[0], 1, data_format)
    x = _layer_stack(bottleneck, x, 256, 128, c[1], 2, data_format)
    x = _layer_stack(bottleneck, x, 512, 256, c[2], 2, data_format)
    x = _layer_stack(bottleneck, x, 1024, 512, c[3], 2, data_format)
    x = layers.pool2d(x, 7, "avg", 1, data_format=data_format)
    return layers.fc(x, class_num)


def resnet50(input, class_num: int = 1000, data_format: str = "NCHW"):
    return resnet(input, 50, class_num, data_format)


def image_classification_program(arch: str = "resnet_cifar10",
                                 class_num: int = 10, hw: int = 32):
    """Full train-graph builder used by the book-style tests."""
    img = layers.data("img", [3, hw, hw], dtype="float32")
    label = layers.data("label", [1], dtype="int64")
    if arch == "resnet_cifar10":
        logits = resnet_cifar10(img, 20, class_num)
    elif arch == "resnet50":
        logits = resnet(img, 50, class_num)
    elif arch == "vgg16":
        raise NotImplementedError(
            "arch='vgg16' needs models/vgg.py, which is not ported to "
            "paddle_tpu_torch yet")
    else:
        raise ValueError(arch)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return {"feed": ["img", "label"], "loss": loss, "logits": logits,
            "acc": acc}
