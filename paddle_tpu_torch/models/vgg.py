"""VGG (reference: tests/book/test_image_classification.py vgg16_bn_drop).
Copied from `paddle_tpu/models/vgg.py`; the convs run on cuDNN."""

from __future__ import annotations

from .. import layers


def _conv_block(input, num_filter, groups, dropouts):
    x = input
    for i in range(groups):
        x = layers.conv2d(x, num_filter, 3, padding=1, bias_attr=False)
        x = layers.batch_norm(x, act="relu")
        if dropouts[i] > 0:
            x = layers.dropout(x, dropouts[i])
    return layers.pool2d(x, 2, "max", 2)


def vgg16(input, class_num: int = 10):
    x = _conv_block(input, 64, 2, [0.3, 0])
    x = _conv_block(x, 128, 2, [0.4, 0])
    x = _conv_block(x, 256, 3, [0.4, 0.4, 0])
    x = _conv_block(x, 512, 3, [0.4, 0.4, 0])
    x = _conv_block(x, 512, 3, [0.4, 0.4, 0])
    x = layers.dropout(x, 0.5)
    x = layers.fc(x, 512, act=None)
    x = layers.batch_norm(x, act="relu")
    x = layers.dropout(x, 0.5)
    x = layers.fc(x, 512, act="relu")
    return layers.fc(x, class_num)
