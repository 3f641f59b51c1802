"""ResNet-50 with modulated deformable convolutions (Zhu et al., "Deformable
ConvNets v2: More Deformable, Better Results", CVPR 2019, sections 3-4) as
a builder over a package argument.

`dcn_resnet50_programs(pkg, ...)` builds it in `pkg` (this package, or any
package with the same layers DSL), in the layout of the repo's
`models/resnet.py`: a 7x7/2 conv + BN + ReLU and a 3x3/2 max pool, then
[3, 4, 6, 3] bottlenecks (1x1, 3x3 with the stage's stride, 1x1 to 4x the
width; a 1x1 projection shortcut where the shape changes), global average
pooling and an fc. As in DCNv2, every 3x3 conv of conv3-conv5 (13 of
them) is a `deformable_conv` whose offsets and masks come from a 3x3 conv
of its input with the same stride, 27 channels, zero initial weights and
0.1 of the learning rate (DCNv2's section 4): 18 (dy, dx) offsets and 9
masks through a sigmoid, so training starts at a plain convolution
scaled by 0.5. The deformable op's Mask takes no
gradient (the JAX rule's no_grad_inputs), so here the masks stay at their
start, where DCNv2 learns them (ROADMAP §C).

The train program ends in softmax cross-entropy and Momentum; its test
clone is taken before `minimize`. tests/test_torch_nn_extra_models.py
builds the full one in both packages and runs a narrow one through both;
chip_smoke.py's phase 4o trains the full one on the card.
"""

STAGES = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)
DEFORMABLE_STAGES = (1, 2, 3)       # conv3, conv4, conv5
NUM_DEFORMABLE = 13
OFFSET_LR = 0.1     # DCNv2's learning rate of the offset/mask convs


def _conv_bn(pkg, x, ch, k, stride, padding, act="relu"):
    L = pkg.layers
    h = L.conv2d(x, ch, k, stride=stride, padding=padding, bias_attr=False)
    return L.batch_norm(h, act=act)


def _deformable_bn(pkg, x, ch, stride, record):
    """DCNv2's 3x3 unit: the offset/mask conv, the modulated deformable
    conv, BN and ReLU. Appends (input, offset conv output, deformable
    output, filter name, stride) to `record`."""
    L = pkg.layers
    zero = pkg.initializer.Constant(0.0)
    om = L.conv2d(x, 27, 3, stride=stride, padding=1,
                  param_attr=pkg.ParamAttr(initializer=zero,
                                           learning_rate=OFFSET_LR),
                  bias_attr=pkg.ParamAttr(initializer=zero,
                                          learning_rate=OFFSET_LR))
    offset, mask = L.split(om, [18, 9], dim=1)
    filt = f"dcn{len(record)}_w"
    y = L.deformable_conv(x, offset, L.sigmoid(mask), ch, 3, stride=stride,
                          padding=1, param_attr=pkg.ParamAttr(name=filt))
    record.append({"input": x, "offset_mask": om, "output": y,
                   "filter": filt, "stride": stride})
    return L.batch_norm(y, act="relu")


def bottleneck(pkg, x, ch_in, ch, stride, deformable, record):
    L = pkg.layers
    h = _conv_bn(pkg, x, ch, 1, 1, 0)
    if deformable:
        h = _deformable_bn(pkg, h, ch, stride, record)
    else:
        h = _conv_bn(pkg, h, ch, 3, stride, 1)
    h = _conv_bn(pkg, h, ch * 4, 1, 1, 0, act=None)
    short = x if ch_in == ch * 4 and stride == 1 else \
        _conv_bn(pkg, x, ch * 4, 1, stride, 0, act=None)
    return L.relu(L.elementwise_add(short, h))


def dcn_resnet50_network(pkg, img, class_num=1000, stages=STAGES, div=1):
    """Logits of the DCNv2 ResNet on `img` [n, 3, h, w], and the
    deformable units' records (see `_deformable_bn`)."""
    L = pkg.layers
    record = []
    h = _conv_bn(pkg, img, 64 // div, 7, 2, 3)
    h = L.pool2d(h, 3, "max", 2, pool_padding=1)
    ch_in = 64 // div
    for s, (count, width) in enumerate(zip(stages, WIDTHS)):
        ch = width // div
        for b in range(count):
            stride = 2 if s > 0 and b == 0 else 1
            h = bottleneck(pkg, h, ch_in, ch, stride,
                            s in DEFORMABLE_STAGES, record)
            ch_in = ch * 4
    h = L.pool2d(h, pool_type="avg", global_pooling=True)
    return L.fc(h, class_num), record


def dcn_resnet50_programs(pkg, class_num=1000, image=224, stages=STAGES,
                          div=1, lr=0.1, momentum=0.9):
    """The train program (mean softmax cross-entropy, Momentum(lr,
    momentum)), its test clone and their startup program. Feeds: "img"
    [n, 3, image, image], "label" [n, 1] int64. Returns a dict: main,
    test, startup, loss, logits, deformable (the units' records). With
    the default [3, 4, 6, 3] stages there are 13 deformable units."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        img = L.data("img", [3, image, image])
        label = L.data("label", [1], dtype="int64")
        logits, record = dcn_resnet50_network(pkg, img, class_num, stages,
                                              div)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        test = main.clone(for_test=True)
        pkg.optimizer.Momentum(lr, momentum).minimize(loss)
    if tuple(stages) == STAGES:
        assert len(record) == NUM_DEFORMABLE, len(record)
    return {"main": main, "test": test, "startup": startup, "loss": loss,
            "logits": logits, "deformable": record}
