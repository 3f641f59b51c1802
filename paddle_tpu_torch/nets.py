"""Composite network helpers (reference: python/paddle/fluid/nets.py —
simple_img_conv_pool, img_conv_group, sequence_conv_pool, glu,
scaled_dot_product_attention).

Copied from `paddle_tpu/nets.py`, with switch_moe_ffn (the Switch top-1
mixture-of-experts FFN)."""

from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "glu",
           "scaled_dot_product_attention", "sequence_conv_pool",
           "switch_moe_ffn"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1,
                         param_attr=None, bias_attr=None, act=None):
    conv = layers.conv2d(input, num_filters, filter_size,
                         stride=conv_stride, padding=conv_padding,
                         dilation=conv_dilation, groups=conv_groups,
                         param_attr=param_attr, bias_attr=bias_attr,
                         act=act)
    return layers.pool2d(conv, pool_size, pool_type, pool_stride,
                         pool_padding, global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max"):
    tmp = input
    if isinstance(conv_with_batchnorm, bool):
        conv_with_batchnorm = [conv_with_batchnorm] * len(conv_num_filter)
    if not isinstance(conv_batchnorm_drop_rate, (list, tuple)):
        conv_batchnorm_drop_rate = \
            [conv_batchnorm_drop_rate] * len(conv_num_filter)
    for i, nf in enumerate(conv_num_filter):
        with_bn = conv_with_batchnorm[i]
        tmp = layers.conv2d(tmp, nf, conv_filter_size,
                            padding=conv_padding,
                            act=None if with_bn else conv_act,
                            bias_attr=False if with_bn else None)
        if with_bn:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i] > 0:
                tmp = layers.dropout(tmp, conv_batchnorm_drop_rate[i])
    return layers.pool2d(tmp, pool_size, pool_type, pool_stride)


def glu(input, dim=-1):
    """Gated linear unit: split in half along dim, a * sigmoid(b)."""
    a, b = layers.split(input, 2, dim=dim)
    return a * layers.sigmoid(b)


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """reference nets.py scaled_dot_product_attention — multi-head
    attention over [b, s, d] tensors as batched matmuls (use
    layers.fused_attention directly for the flash/ring kernel path)."""
    d_model = queries.shape[-1]
    if d_model % num_heads != 0:
        raise ValueError("num_heads must divide d_model")
    dk = d_model // num_heads

    def split_heads(x):
        # [b, s, d] -> [b, h, s, dk]
        y = layers.reshape(x, [0, x.shape[1], num_heads, dk])
        return layers.transpose(y, [0, 2, 1, 3])

    q = split_heads(layers.fc(queries, d_model, num_flatten_dims=2,
                              bias_attr=False))
    k = split_heads(layers.fc(keys, d_model, num_flatten_dims=2,
                              bias_attr=False))
    v = split_heads(layers.fc(values, d_model, num_flatten_dims=2,
                              bias_attr=False))
    scores = layers.matmul(q, layers.transpose(k, [0, 1, 3, 2]))
    weights = layers.softmax(layers.scale(scores, scale=dk ** -0.5))
    if dropout_rate > 0:
        weights = layers.dropout(weights, dropout_rate)
    ctx = layers.matmul(weights, v)                   # [b, h, s, dk]
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, ctx.shape[1], d_model])
    return layers.fc(ctx, d_model, num_flatten_dims=2, bias_attr=False)


def sequence_conv_pool(input, num_filters, filter_size, lengths=None,
                       act="sigmoid", pool_type="max"):
    """1-D windowed conv over [b, s, d] + sequence pool (reference
    nets.py sequence_conv_pool for text CNNs). The k-token window is built
    by concatenating k shifted copies along the feature dim (same math as
    sequence_conv with zero padding) and projecting once — one matmul
    instead of a sliding loop."""
    k = int(filter_size)
    if k == 1:
        win = input
    else:
        before = (k - 1) // 2
        s_len = input.shape[1]
        shifted = []
        for off in range(-before, k - before):
            if off == 0:
                shifted.append(input)
                continue
            # shift via slice + concat of a zero block
            if off < 0:
                body = layers.slice(input, axes=[1], starts=[0],
                                    ends=[s_len + off])
                zed = layers.scale(layers.slice(
                    input, axes=[1], starts=[0], ends=[-off]), scale=0.0)
                shifted.append(layers.concat([zed, body], axis=1))
            else:
                body = layers.slice(input, axes=[1], starts=[off],
                                    ends=[s_len])
                zed = layers.scale(layers.slice(
                    input, axes=[1], starts=[0], ends=[off]), scale=0.0)
                shifted.append(layers.concat([body, zed], axis=1))
        win = layers.concat(shifted, axis=2)
    conv = layers.fc(win, num_filters, num_flatten_dims=2, act=act)
    return layers.sequence_pool(conv, pool_type, lengths=lengths)


def switch_moe_ffn(x, num_experts, d_model, d_ffn, capacity_factor=1.25,
                   name_prefix=None):
    """Switch-style top-1 mixture-of-experts FFN (`paddle_tpu/nets.py`
    switch_moe_ffn, op for op).

    Formulation is the Mesh-TensorFlow/GSPMD dispatch-combine einsum over
    [e, d, f] expert weights (the expert-parallel sharding of that axis is
    the parallelism slice, ROADMAP A.8; here every expert runs on one
    device, as torch.einsum contractions). Returns (output [b, s, d], aux_loss) where aux_loss is
    the load-balancing loss (mean fraction * mean router prob, scaled by
    num_experts).

    Capacity: each expert processes at most
    ceil(tokens/experts * capacity_factor) tokens per batch; overflow
    tokens pass through the residual (their expert output is zeroed) —
    the standard Switch behavior, static shapes throughout.
    """
    import math as _math

    from .framework.core import unique_name
    from .framework.layer_helper import ParamAttr

    if name_prefix is None:
        # stacked layers must not silently alias one weight set
        name_prefix = unique_name("moe")

    b_s_d = x.shape
    seq = int(b_s_d[1])
    e = int(num_experts)

    router = layers.fc(x, e, num_flatten_dims=2, bias_attr=False,
                       param_attr=ParamAttr(name=f"{name_prefix}/router.w"))
    probs = layers.softmax(router, axis=-1)              # [b, s, e]
    gate = layers.reduce_max(probs, dim=-1, keep_dim=True)   # [b, s, 1]
    # top-1 via argmax one-hot: ties (e.g. all-zero padding tokens with
    # uniform probs) must pick ONE expert, not flood every queue
    top_idx = layers.argmax(probs, axis=-1)              # [b, s]
    assign = layers.one_hot(top_idx, e)                  # [b, s, e]

    # capacity masking: position of each token within its expert's queue
    cap = int(_math.ceil(seq * capacity_factor / e))
    pos = layers.cumsum(assign, axis=1)                 # [b, s, e]
    keep = layers.cast(
        layers.less_equal(pos, layers.fill_constant([1], "float32",
                                                    float(cap))),
        "float32") * assign                              # [b, s, e]

    # dispatch mask (Mesh-TF/GSPMD formulation): tokens GATHER into each
    # expert's fixed [cap] queue instead of a dense [b, e, s, d] copy —
    # expert flops become b*cap*e (≈ capacity_factor x the dense FFN)
    # rather than e x the dense FFN, the difference between MoE being a
    # win and an 8x tax (BASELINE.md r5 MoE row; static shapes kept).
    slot = layers.reduce_sum(pos * assign, dim=-1, keep_dim=False)
    slot_idx = layers.cast(
        layers.clip(slot - 1.0, 0.0, float(cap - 1)), "int64")
    slot_oh = layers.one_hot(slot_idx, cap)              # [b, s, cap]
    mask4 = layers.einsum("bse,bsc->bsec", keep, slot_oh)

    disp = layers.einsum("bsec,bsd->ebcd", mask4, x)     # [e, b, cap, d]

    w1 = layers.create_parameter([e, d_model, d_ffn], "float32",
                                 attr=ParamAttr(name=f"{name_prefix}/w1"))
    w2 = layers.create_parameter([e, d_ffn, d_model], "float32",
                                 attr=ParamAttr(name=f"{name_prefix}/w2"))
    h = layers.relu(layers.einsum("ebcd,edf->ebcf", disp, w1))
    y = layers.einsum("ebcf,efd->ebcd", h, w2)           # [e, b, cap, d]
    # combine weighted by the router prob of the chosen expert
    comb = layers.einsum("bsec,bse->bsec", mask4, probs)
    out = layers.einsum("ebcd,bsec->bsd", y, comb)

    # load-balancing aux loss (Switch eq. 4): e * sum_e f_e * P_e
    frac = layers.reduce_mean(assign, dim=[0, 1])        # [e]
    mean_prob = layers.reduce_mean(probs, dim=[0, 1])    # [e]
    aux = layers.scale(layers.reduce_sum(frac * mean_prob), scale=float(e))
    return out, aux
