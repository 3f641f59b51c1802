"""LeNet-5 built with the layers DSL (reference: the conv_net model in
tests/book/test_recognize_digits.py). Copied from
`paddle_tpu/models/lenet.py`; the convs run on cuDNN."""

import paddle_tpu_torch as pt

__all__ = ["lenet"]


def lenet(img, class_num: int = 10):
    c1 = pt.layers.conv2d(img, num_filters=6, filter_size=5, padding=2,
                          act="relu")
    p1 = pt.layers.pool2d(c1, pool_size=2, pool_type="max", pool_stride=2)
    c2 = pt.layers.conv2d(p1, num_filters=16, filter_size=5, act="relu")
    p2 = pt.layers.pool2d(c2, pool_size=2, pool_type="max", pool_stride=2)
    f1 = pt.layers.fc(p2, size=120, act="relu")
    f2 = pt.layers.fc(f1, size=84, act="relu")
    return pt.layers.fc(f2, size=class_num)
