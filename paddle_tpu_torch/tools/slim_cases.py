"""ResNet-50 quantization-aware training (QAT) programs, built in the
package passed in.

`slim_resnet50_programs(pkg, ...)` builds, in `pkg` (this package, or any
package with the same layers DSL, passes and `contrib.slim`), the
ImageNet ResNet-50 of `models/resnet.py` (224x224, 1000 classes, mean
softmax cross-entropy), then in this order:

  * with `fuse`, the `fuse_elewise_add_act` pass: each bottleneck's
    `relu(short + conv3)` becomes one `fused_elemwise_activation` op (16
    of them in ResNet-50);
  * with `quant`, `QuantizationTransformPass` with channel-wise abs-max
    weights and moving-average abs-max activations (Paddle 1.5 slim's QAT
    setting): a fake quantize-dequantize op before the input and the
    weight of every conv2d and mul, the activations' moving scales held
    in persistable state vars that the startup program zeroes;
  * the test clone;
  * Momentum(lr, momentum).minimize(loss).

With neither pass it is the fp32 program that post-training quantization
starts from. tests/test_torch_slim.py builds the QAT program in both
packages; chip_smoke.py's phase 4p trains it on the card.
"""

import importlib

NUM_BOTTLENECKS = 16        # ResNet-50's [3, 4, 6, 3]


def slim_resnet50_programs(pkg, class_num=1000, image=224, depth=50,
                           fuse=True, quant=True, lr=1e-3, momentum=0.9):
    """Returns a dict: main, test, startup, loss, logits, and `states`,
    the names of the activation scales' state vars (empty without
    `quant`). Feeds: "img" [n, 3, image, image], "label" [n, 1] int64."""
    resnet = importlib.import_module(pkg.__name__ + ".models.resnet")
    slim = importlib.import_module(pkg.__name__ + ".contrib.slim")
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        img = L.data("img", [3, image, image])
        label = L.data("label", [1], dtype="int64")
        logits = resnet.resnet(img, depth, class_num)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        if fuse:
            pkg.framework.apply_pass("fuse_elewise_add_act", main)
        if quant:
            slim.QuantizationTransformPass(
                activation_quantize_type="moving_average_abs_max",
                weight_quantize_type="channel_wise_abs_max").apply(
                    main, startup)
        test = main.clone(for_test=True)
        pkg.optimizer.Momentum(lr, momentum).minimize(loss)
    states = sorted(op.inputs["InScale"][0]
                    for op in main.global_block.ops
                    if op.type == "fake_quantize_dequantize_moving_average"
                    "_abs_max")
    return {"main": main, "test": test, "startup": startup, "loss": loss,
            "logits": logits, "states": states}
