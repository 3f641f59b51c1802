"""Fused op family (reference: paddle/fluid/operators/fused/).

Port of `paddle_tpu/ops/fused_ops.py`. These are API-level op *types*
that reference programs (CTR models, inference transforms, the
fuse_elewise_add_act pass) emit. In the JAX package each lowers to the
graph its unfused pieces would and XLA fuses it; the eager port runs the
same pieces as torch ops, one after another, so a fused type gives the
unfused ops' results. The `fusion_*` recurrences are time loops over the
port's `lstm_scan` and `_gru_cell` (`ops/rnn_ops.py`), as A.6's are.

Dense layout conventions as everywhere: sequences are [b, s, d] padded
(+ optional *Length inputs), not LoD ragged rows.
"""

import torch
import torch.nn.functional as F

from ..framework.registry import register_op
from .rnn_ops import _ACTS, _freeze, _gru_cell, lstm_scan, ragged_flip
from .sequence_ops import _sequence_conv, _sequence_pool


# ---------------------------------------------------------------------------
# elementwise + activation
# ---------------------------------------------------------------------------

_BINARY = {
    "elementwise_add": lambda x, y: x + y,
    "elementwise_sub": lambda x, y: x - y,
    "elementwise_mul": lambda x, y: x * y,
    "elementwise_div": lambda x, y: x / y,
    "elementwise_max": torch.maximum,
    "elementwise_min": torch.minimum,
}


def _relu6(v):
    return torch.clamp(v, 0.0, 6.0)


def _unary(name, scale):
    if name == "scale":
        return lambda v: v * scale
    if name in _ACTS:
        return _ACTS[name]
    if name == "relu6":
        return _relu6
    raise NotImplementedError(f"fused_elemwise_activation functor {name!r}")


def _bcast_y(x, y, axis):
    """Reference elementwise broadcast: align y's dims to x starting at
    `axis` (elementwise_op_function.h)."""
    if y.ndim == x.ndim:
        return y
    if axis < 0:
        axis = x.ndim - y.ndim
    return y.reshape((1,) * axis + tuple(y.shape)
                     + (1,) * (x.ndim - axis - y.ndim))


@register_op("fused_elemwise_activation")
def _fused_elemwise_activation(ctx, ins, attrs):
    """reference: fused/fused_elemwise_activation_op.cc: two functors
    f1(f2(x, y)) composed. functor_list = [outer, inner]; if the SECOND
    entry is the binary one, the compound is unary(binary(x, y)), else
    binary(x, unary(y)) (IsUnaryCompound, :22)."""
    x, y = ins["X"][0], ins["Y"][0]
    f_outer, f_inner = attrs["functor_list"]
    scale = attrs.get("scale", 0.0)
    axis = attrs.get("axis", -1)
    if f_inner in _BINARY:  # unary(binary(x, y))
        mid = _BINARY[f_inner](x, _bcast_y(x, y, axis))
        out = _unary(f_outer, scale)(mid)
    else:                   # binary(x, unary(y))
        mid = _unary(f_inner, scale)(y)
        out = _BINARY[f_outer](x, _bcast_y(x, mid, axis))
    return {"Out": [out], "IntermediateOut": [mid]}


# ---------------------------------------------------------------------------
# embedding fusions
# ---------------------------------------------------------------------------

def _flat_ids(ids):
    # the reference feeds [b, s, 1]
    return ids.reshape(ids.shape[0], -1) if ids.ndim > 2 else ids


@register_op("fused_embedding_seq_pool", no_grad_inputs={"Ids", "IdsLength"})
def _fused_embedding_seq_pool(ctx, ins, attrs):
    """reference: fused/fused_embedding_seq_pool_op.cc: lookup_table +
    sequence_pool(sum) in one op (CTR models). Ids [b, s] (+ optional
    IdsLength mask); W [V, D] -> Out [b, D]."""
    w = ins["W"][0]
    ids = _flat_ids(ins["Ids"][0])
    if attrs.get("combiner", "sum") != "sum":
        raise NotImplementedError(
            "fused_embedding_seq_pool supports combiner='sum' (the only "
            "combiner the reference implements)")
    emb = w[ids.long()]                             # [b, s, D]
    if "IdsLength" in ins:
        ln = ins["IdsLength"][0].reshape(-1)
        m = (torch.arange(ids.shape[1], device=ids.device)[None, :]
             < ln[:, None])
        emb = emb * m[:, :, None].to(emb.dtype)
    return {"Out": [torch.sum(emb, dim=1)]}


# ---------------------------------------------------------------------------
# recurrent fusions: x-projection folded into the op
# ---------------------------------------------------------------------------

def _maybe(ins, slot):
    return ins[slot][0] if slot in ins else None


@register_op("fusion_gru", no_grad_inputs={"SequenceLength"},
             non_diff_outputs={"XX"})
def _fusion_gru(ctx, ins, attrs):
    """reference: fused/fusion_gru_op.cc: fc (XX = X @ WeightX) + GRU in
    one op. X [b, s, M], WeightX [M, 3D], WeightH [D, 3D], Bias [1, 3D]."""
    x = ins["X"][0]
    wx = ins["WeightX"][0]
    wh = ins["WeightH"][0]
    bias = ins["Bias"][0].reshape(-1) if "Bias" in ins else None
    lengths = _maybe(ins, "SequenceLength")
    h = _maybe(ins, "H0")
    act = attrs.get("activation", "tanh")
    gate_act = attrs.get("gate_activation", "sigmoid")
    reverse = attrs.get("is_reverse", False)
    xx = x @ wx                                     # [b, s, 3D]
    if reverse:
        xx = ragged_flip(xx, lengths)
    if h is None:
        h = torch.zeros((x.shape[0], wh.shape[0]), dtype=x.dtype,
                        device=x.device)
    hs = []
    for t in range(xx.shape[1]):
        h_new, _, _ = _gru_cell(xx[:, t], h, wh, bias, act, gate_act)
        if lengths is not None:
            h_new = _freeze(h_new, h, t, lengths, x.dtype)
        h = h_new
        hs.append(h)
    hidden = torch.stack(hs, dim=1)
    if reverse:
        hidden = ragged_flip(hidden, lengths)
    return {"Hidden": [hidden], "XX": [xx]}


def _lstm_attrs(attrs):
    return dict(use_peepholes=attrs.get("use_peepholes", False),
                gate_act=attrs.get("gate_activation", "sigmoid"),
                cell_act=attrs.get("cell_activation", "tanh"),
                cand_act=attrs.get("candidate_activation", "tanh"),
                is_reverse=attrs.get("is_reverse", False))


@register_op("fusion_lstm", no_grad_inputs={"SequenceLength"},
             non_diff_outputs={"XX"})
def _fusion_lstm(ctx, ins, attrs):
    """reference: fused/fusion_lstm_op.cc: fc + LSTM. X [b, s, M],
    WeightX [M, 4D], WeightH [D, 4D], Bias [1, 4D] ([1, 7D] peephole)."""
    xx = ins["X"][0] @ ins["WeightX"][0]
    hidden, cell, _, _ = lstm_scan(
        xx, ins["WeightH"][0], _maybe(ins, "Bias"),
        _maybe(ins, "H0"), _maybe(ins, "C0"),
        lengths=_maybe(ins, "SequenceLength"), **_lstm_attrs(attrs))
    return {"Hidden": [hidden], "Cell": [cell], "XX": [xx]}


@register_op("fused_embedding_fc_lstm",
             no_grad_inputs={"Ids", "SequenceLength"})
def _fused_embedding_fc_lstm(ctx, ins, attrs):
    """reference: fused/fused_embedding_fc_lstm_op.cc: the embedding table
    is PRE-PROJECTED (Embeddings = emb_table @ WeightX, folded offline), so
    the lookup directly yields the gate pre-activations. Ids [b, s],
    Embeddings [V, 4D], WeightH [D, 4D]."""
    ids = _flat_ids(ins["Ids"][0])
    xx = ins["Embeddings"][0][ids.long()]           # [b, s, 4D]
    hidden, cell, _, _ = lstm_scan(
        xx, ins["WeightH"][0], _maybe(ins, "Bias"),
        _maybe(ins, "H0"), _maybe(ins, "C0"),
        lengths=_maybe(ins, "SequenceLength"), **_lstm_attrs(attrs))
    return {"Hidden": [hidden], "Cell": [cell], "XX": [xx]}


@register_op("cudnn_lstm", no_grad_inputs={"SequenceLength"},
             non_diff_outputs={"LastH", "LastC"})
def _cudnn_lstm(ctx, ins, attrs):
    """reference: cudnn_lstm_op.cc: multi-layer (optionally bidirectional)
    LSTM over one flat weight buffer in the JAX package's layout: per
    layer and direction, [Wx (in, 4h) | Wh (h, 4h) | b (4h)] flattened in
    that order, gates i, f, c, o. Not torch.nn.LSTM, whose flat layout
    and gate order differ."""
    x = ins["Input"][0]                             # [b, s, in]
    w = ins["W"][0].reshape(-1)
    h_size = int(attrs["hidden_size"])
    layers = int(attrs.get("num_layers", 1))
    ndir = 2 if bool(attrs.get("is_bidirec", False)) else 1
    lengths = _maybe(ins, "SequenceLength")
    init_h = _maybe(ins, "InitH")                   # [layers*ndir, b, h]
    init_c = _maybe(ins, "InitC")

    off = 0

    def take(n, shape):
        nonlocal off
        v = w[off:off + n].reshape(shape)
        off += n
        return v

    out = x
    lasts_h, lasts_c = [], []
    for layer in range(layers):
        in_size = out.shape[-1]
        dirs = []
        for d in range(ndir):
            wx = take(in_size * 4 * h_size, (in_size, 4 * h_size))
            wh = take(h_size * 4 * h_size, (h_size, 4 * h_size))
            bb = take(4 * h_size, (4 * h_size,))
            idx = layer * ndir + d
            h0 = init_h[idx] if init_h is not None else None
            c0 = init_c[idx] if init_c is not None else None
            hidden, _, h_l, c_l = lstm_scan(
                out @ wx, wh, bb, h0, c0, lengths=lengths,
                is_reverse=(d == 1))
            dirs.append(hidden)
            lasts_h.append(h_l)
            lasts_c.append(c_l)
        out = dirs[0] if ndir == 1 else torch.cat(dirs, dim=-1)
    return {"Out": [out],
            "LastH": [torch.stack(lasts_h)], "LastC": [torch.stack(lasts_c)]}


# ---------------------------------------------------------------------------
# MLP / attention-adjacent fusions
# ---------------------------------------------------------------------------

@register_op("fusion_repeated_fc_relu")
def _fusion_repeated_fc_relu(ctx, ins, attrs):
    """reference: fused/fusion_repeated_fc_relu_op.cc: N stacked fc+relu
    stages. W/Bias are duplicable input lists."""
    out = ins["X"][0]
    relu_outs = []
    for w, b in zip(ins["W"], ins["Bias"]):
        out = torch.relu(out @ w + b.reshape(-1))
        relu_outs.append(out)
    return {"Out": [out], "ReluOut": relu_outs[:-1]}


@register_op("fusion_squared_mat_sub")
def _fusion_squared_mat_sub(ctx, ins, attrs):
    """reference: fused/fusion_squared_mat_sub_op.cc:
    out = scalar * ((X @ Y)^2 - (X^2 @ Y^2))."""
    x, y = ins["X"][0], ins["Y"][0]
    scalar = attrs.get("scalar", 1.0)
    sx, sy = x * x, y * y
    sxy = torch.square(x @ y)
    out = scalar * (sxy - sx @ sy)
    return {"Out": [out], "SquaredX": [sx], "SquaredY": [sy],
            "SquaredXY": [sxy]}


@register_op("fusion_seqconv_eltadd_relu", no_grad_inputs={"XLength"})
def _fusion_seqconv_eltadd_relu(ctx, ins, attrs):
    """reference: fused/fusion_seqconv_eltadd_relu_op.cc: sequence_conv +
    bias add + relu."""
    r = _sequence_conv(
        ctx, {k: ins[k] for k in ("X", "Filter", "XLength") if k in ins},
        {"context_length": attrs.get("contextLength",
                                     attrs.get("context_length", 3)),
         "context_start": attrs.get("contextStart",
                                    attrs.get("context_start", 0))})
    out = torch.relu(r["Out"][0] + ins["Bias"][0].reshape(-1))
    return {"Out": [out], "ColMat": [r["Out"][0]]}


@register_op("fusion_seqexpand_concat_fc", no_grad_inputs={"XLength"})
def _fusion_seqexpand_concat_fc(ctx, ins, attrs):
    """reference: fused/fusion_seqexpand_concat_fc_op.cc: X[0] is the
    reference sequence [b, s, d0]; X[1:] are per-sequence vectors [b, dk]
    broadcast across steps; concat features -> fc -> activation."""
    seq = ins["X"][0]
    s = seq.shape[1]
    feats = [seq]
    for v in ins["X"][1:]:
        feats.append(v[:, None].expand((v.shape[0], s) + tuple(v.shape[1:])))
    out = torch.cat(feats, dim=-1) @ ins["FCWeight"][0]
    if "FCBias" in ins:
        out = out + ins["FCBias"][0].reshape(-1)
    return {"Out": [_ACTS[attrs.get("fc_activation", "identity")](out)]}


def _pool_each(xs, lengths_list, pooltype):
    outs = []
    for i, x in enumerate(xs):
        ins = {"X": [x]}
        if lengths_list is not None and i < len(lengths_list):
            ins["Length"] = [lengths_list[i]]
        outs.append(_sequence_pool(None, ins, {"pooltype": pooltype})
                    ["Out"][0])
    return outs


@register_op("fusion_seqpool_concat", no_grad_inputs={"XLength"})
def _fusion_seqpool_concat(ctx, ins, attrs):
    """reference: fused/fusion_seqpool_concat_op.cc: sequence_pool each
    input, concat the pooled vectors along axis 1."""
    pooled = _pool_each(ins["X"], ins.get("XLength"),
                        attrs.get("pooltype", "SUM"))
    return {"Out": [torch.cat(pooled, dim=attrs.get("axis", 1))]}


@register_op("fusion_seqpool_cvm_concat",
             no_grad_inputs={"CVM", "XLength"})
def _fusion_seqpool_cvm_concat(ctx, ins, attrs):
    """reference: fused/fusion_seqpool_cvm_concat_op.cc: pool + cvm
    transform + concat (the CTR show/click feature pipeline)."""
    from .nn_extra_ops import _cvm
    pooled = _pool_each(ins["X"], ins.get("XLength"),
                        attrs.get("pooltype", "SUM"))
    use_cvm = bool(attrs.get("use_cvm", True))
    pooled = [_cvm(None, {"X": [p], "CVM": ins.get("CVM", [None])},
                   {"use_cvm": use_cvm})["Y"][0] for p in pooled]
    return {"Out": [torch.cat(pooled, dim=attrs.get("axis", 1))]}


@register_op("fusion_transpose_flatten_concat")
def _fusion_transpose_flatten_concat(ctx, ins, attrs):
    """reference: fused/fusion_transpose_flatten_concat_op.cc."""
    trans = tuple(attrs["trans_axis"])
    flat_axis = int(attrs["flatten_axis"])
    cat_axis = int(attrs["concat_axis"])
    outs = []
    for x in ins["X"]:
        t = x.permute(trans)
        lead = 1
        for d in t.shape[:flat_axis]:
            lead *= d
        outs.append(t.reshape(lead, -1))
    return {"Out": [torch.cat(outs, dim=cat_axis)]}


@register_op("conv2d_fusion")
def _conv2d_fusion(ctx, ins, attrs):
    """reference: conv_fusion_op.cc (cudnn conv + bias + act (+ residual)
    epilogue), here the conv2d rule followed by the epilogue's ops."""
    from .nn_ops import _conv2d
    out = _conv2d(ctx, {"Input": ins["Input"], "Filter": ins["Filter"]},
                  attrs)["Output"][0]
    if "Bias" in ins:
        b = ins["Bias"][0].reshape(-1)
        fmt = attrs.get("data_format", "NCHW")
        out = out + (b[None, :, None, None] if fmt == "NCHW" else b)
    if "ResidualData" in ins and ins["ResidualData"]:
        out = out + ins["ResidualData"][0]
    act = attrs.get("activation", "relu")
    return {"Output": [_ACTS.get(act, _ACTS["identity"])(out)
                       if act != "relu6" else _relu6(out)]}


def _window_sum(x):
    """3x3 stride-1 sums over a zero-padded border (JAX's reduce_window
    add with (1, 1) padding)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True,
                        divisor_override=1)


@register_op("conv2d_inception_fusion")
def _conv2d_inception_fusion(ctx, ins, attrs):
    """reference: fused/fusion_conv_inception_op.cu: the 4-branch
    inception cell: [act(conv1x1(pool3x3(x))) | direct 1x1 slice |
    grouped conv on the 1x1's remaining channels | conv on that grouped
    conv's second half], concatenated on channels. NCHW; all convs
    stride 1, SAME. The average pool divides the window's sum by its
    count of in-image elements (`exclusive`, the default) or by 9."""
    x = ins["Input"][0]
    f0, f1, f2, f3 = ins["Filter"]
    b0, b1, b2, b3 = [b.reshape(-1) for b in ins["Bias"]]
    act = _ACTS[attrs.get("activation", "relu")]

    # 3x3 stride-1 SAME pool on the input feeds branch 0
    if attrs.get("pooling_type", "max") == "max":
        pooled = F.max_pool2d(x, 3, 1, 1)
    else:
        s = _window_sum(x)
        if attrs.get("exclusive", True):
            pooled = s / _window_sum(torch.ones_like(x))
        else:
            pooled = s / torch.full((), 9.0, dtype=s.dtype, device=s.device)

    def conv(inp, f, bias, groups=1):
        k = f.shape[2]
        o = F.conv2d(inp, f, stride=1, padding=k // 2, groups=groups)
        return act(o + bias[None, :, None, None])

    br0 = conv(pooled, f0, b0)                      # oc0
    c1 = conv(x, f1, b1)                            # oc1 + 2*ic2
    ic2 = f2.shape[1]
    oc1 = f1.shape[0] - 2 * ic2
    br1, rest = c1[:, :oc1], c1[:, oc1:]
    c2 = conv(rest, f2, b2, groups=2)               # 2 halves
    half = f2.shape[0] // 2
    br2, mid = c2[:, :half], c2[:, half:]
    br3 = conv(mid, f3, b3)                         # oc3
    return {"Output": [torch.cat([br0, br1, br2, br3], dim=1)]}
