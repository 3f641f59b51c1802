"""DCGAN's training programs (Radford et al., "Unsupervised Representation
Learning with Deep Convolutional GANs", arXiv:1511.06434, section 4 and
Fig. 1) as builders over a package argument.

`dcgan_programs(pkg, ...)` builds them in `pkg` (this package, or any
package with the same layers DSL). tests/test_torch_core_layers.py runs a
narrow one through both packages on the CPU; chip_smoke.py's phase 4m runs
one at the paper's widths on the card against the CPU.
"""


def _param(pkg, name):
    return pkg.ParamAttr(name=name,
                         initializer=pkg.initializer.Normal(0.0, 0.02))


def _batch_norm(pkg, x, name, act):
    return pkg.layers.batch_norm(
        x, act=act, param_attr=pkg.ParamAttr(
            name=name + "_s", initializer=pkg.initializer.Normal(1.0, 0.02)),
        bias_attr=name + "_b", moving_mean_name=name + "_m",
        moving_variance_name=name + "_v")


def dcgan_generator(pkg, z, ngf, depth):
    """z [b, nz, 1, 1] -> tanh image [b, 3, 4 * 2^depth, ...]: conv2d_transpose
    k4 s1 p0 to 4x4 x ngf 2^(depth - 1), then depth k4 s2 p1 layers
    halving the channels, the last to 3; batch_norm + relu on all but the
    last."""
    L = pkg.layers
    ch = ngf * 2 ** (depth - 1)
    h = L.conv2d_transpose(z, ch, 4, stride=1, padding=0,
                           param_attr=_param(pkg, "g0_w"), bias_attr=False)
    h = _batch_norm(pkg, h, "g0_bn", "relu")
    for i in range(1, depth + 1):
        last = i == depth
        ch = 3 if last else ch // 2
        h = L.conv2d_transpose(h, ch, 4, stride=2, padding=1,
                               param_attr=_param(pkg, f"g{i}_w"),
                               bias_attr=False)
        h = L.tanh(h) if last else _batch_norm(pkg, h, f"g{i}_bn", "relu")
    return h


def dcgan_discriminator(pkg, x, ndf, depth):
    """Image -> one logit: depth conv2d k4 s2 p1 doubling from ndf,
    leaky_relu 0.2, batch_norm on all but the first; a k4 s1 p0 conv to
    one logit."""
    L = pkg.layers
    h, ch = x, ndf
    for i in range(depth):
        h = L.conv2d(h, ch, 4, stride=2, padding=1,
                     param_attr=_param(pkg, f"d{i}_w"), bias_attr=False)
        if i:
            h = _batch_norm(pkg, h, f"d{i}_bn", None)
        h = L.leaky_relu(h, 0.2)
        ch *= 2
    h = L.conv2d(h, 1, 4, stride=1, padding=0,
                 param_attr=_param(pkg, f"d{depth}_w"), bias_attr=False)
    return L.reshape(h, [-1, 1])


def dcgan_programs(pkg, nz, ngf, ndf, img, lr=2e-4, beta1=0.5):
    """The D-step and G-step programs of DCGAN training over one startup
    program: D on a real batch and on G(z) with labels 1 and 0; G through
    D with label 1; sigmoid_cross_entropy_with_logits, Adam(lr, beta1) on
    each side's own parameters; the D step stops the gradient at G's
    output. Returns ({"d" | "g": (main, loss, parameter names)},
    startup)."""
    L = pkg.layers
    depth = (img // 4).bit_length() - 1
    startup = pkg.Program()
    progs = {}
    with pkg.unique_name_guard():
        for side in ("d", "g"):
            main = pkg.Program()
            with pkg.program_guard(main, startup):
                z = L.data("z", [nz, 1, 1])
                fake = dcgan_generator(pkg, z, ngf, depth)
                if side == "d":
                    fake.stop_gradient = True      # G is not trained here
                    real = L.data("real", [3, img, img])
                    lr_ = dcgan_discriminator(pkg, real, ndf, depth)
                    lf = dcgan_discriminator(pkg, fake, ndf, depth)
                    loss = L.elementwise_add(
                        L.mean(L.sigmoid_cross_entropy_with_logits(
                            lr_, L.ones_like(lr_))),
                        L.mean(L.sigmoid_cross_entropy_with_logits(
                            lf, L.zeros_like(lf))))
                else:
                    lf = dcgan_discriminator(pkg, fake, ndf, depth)
                    loss = L.mean(L.sigmoid_cross_entropy_with_logits(
                        lf, L.ones_like(lf)))
                params = [p.name for p in main.global_block.all_parameters()
                          if p.trainable and p.name.startswith(side)]
                pkg.optimizer.Adam(lr, beta1=beta1).minimize(
                    loss, parameter_list=params)
            progs[side] = (main, loss, params)
    return progs, startup
