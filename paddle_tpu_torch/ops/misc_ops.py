"""Ops of `paddle_tpu/ops/misc_ops.py`, every rule of the file by name:
pixel_shuffle (:32), shuffle_channel (:42), space_to_depth (:51),
temporal_shift (:61), unfold (:91), im2sequence (:106), add_position_encoding
(:118), linspace (:140), shard_index (:152), norm (:166), dist (:177),
cross (:191), kron (:197), trace (:202), diag (:210), meshgrid (:215),
bilinear_tensor_product (:221), cos_sim (:236), rank_loss (:245),
margin_rank_loss (:254), bpr_loss (:263), log_loss (:277), hinge_loss
(:286), modified_huber_loss (:293), teacher_student_sigmoid_loss (:303),
gather_tree (:322), sampling_id (:340), print (:355), isnan (:384), isinf
(:389) and sign (:394, the JAX registry's final, differentiable rule).

Grads take the generic vjp path; gather_tree, linspace, shard_index, diag,
meshgrid, sampling_id, isnan and isinf have none, as in JAX. unfold and
im2sequence read their patches by advanced indexing (JAX's
conv_general_dilated_patches: channel-major (c, kh, kw) rows, exact
copies), so their gradient is a sort-based index_put_. jnp.maximum,
jnp.max and jnp.clip split a tie's gradient evenly; the losses use
torch.maximum/amax, which do too. sampling_id draws Gumbel noise from
the run's torch.Generator (JAX: jax.random.categorical's Gumbel-max on
its key; other numbers, ROADMAP §C). print passes X through and writes
one line to stdout in jax.debug.print's format (numpy's scalar and array
formatting); on the card that reads the values back (a synchronisation a
call).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..framework.registry import dtype_name, register_op
from .nn_ops import linspace_f32


@register_op("add_position_encoding")
def _add_position_encoding(ctx, ins, attrs):
    """reference add_position_encoding_op.cc: sinusoidal PE added to
    [b, s, d]; for odd d the sin half takes the extra column. The angle
    pos / 10000**(2i/d) is computed in f32 in the JAX rule's order: near
    pos 255 one ulp of the angle moves its sine by ~3e-5."""
    x = ins["X"][0]
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    _, s, d = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    pos = torch.arange(s, **f32)[:, None]
    half_sin = (d + 1) // 2
    i_sin = torch.arange(half_sin, **f32)[None, :]
    i_cos = torch.arange(d - half_sin, **f32)[None, :]
    # a python base: an f32 pow like jnp.power's, with no host-to-device
    # copy of a 0-d tensor (which would synchronize a decode step)
    pe = torch.cat([torch.sin(pos / torch.pow(10000.0, 2 * i_sin / d)),
                    torch.cos(pos / torch.pow(10000.0, 2 * i_cos / d))],
                   dim=1)
    return {"Out": [alpha * x + beta * pe[None, :, :].to(x.dtype)]}


@register_op("gather_tree", not_differentiable=True, grad_free=True)
def _gather_tree(ctx, ins, attrs):
    """Backtrace beam-search parent pointers (reference
    gather_tree_op.cc): Ids/Parents [t, b, beam] -> full sequences. A loop
    over t in reverse, one gather of the ids and one of the parents a
    step, on the tensors' device (JAX: a lax.scan over reversed t)."""
    ids, parents = ins["Ids"][0], ins["Parents"][0]
    t, b, beam = ids.shape
    idx = torch.arange(beam, device=ids.device).expand(b, beam)
    outs = [None] * t
    for ti in range(t - 1, -1, -1):
        outs[ti] = torch.gather(ids[ti], -1, idx)
        idx = torch.gather(parents[ti].long(), -1, idx)
    if not outs:
        return {"Out": [ids.clone()]}
    return {"Out": [torch.stack(outs)]}


@register_op("log_loss", no_grad_inputs={"Labels"})
def _log_loss(ctx, ins, attrs):
    """Binary cross-entropy on probabilities (reference log_loss_op.h);
    the op's default epsilon is 1e-7, the layer's 1e-4."""
    p = ins["Predicted"][0]
    y = ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-7)
    return {"Loss": [-y * torch.log(p + eps)
                     - (1 - y) * torch.log(1 - p + eps)]}


@register_op("linspace", not_differentiable=True, grad_free=True)
def _linspace(ctx, ins, attrs):
    """`num` must be a static attr, as in JAX (a tensor Num would be a
    dynamic output shape); f32 with jnp.linspace's arithmetic."""
    if "num" not in attrs:
        raise ValueError("linspace requires the static attr 'num' "
                         "(tensor Num means a dynamic shape under XLA)")
    start = ins["Start"][0].reshape(()).float()
    stop = ins["Stop"][0].reshape(()).float()
    return {"Out": [linspace_f32(start, stop, int(attrs["num"]),
                                 start.device)]}


@register_op("shard_index", not_differentiable=True, grad_free=True)
def _shard_index(ctx, ins, attrs):
    """reference shard_index_op.cc: global ids to shard-local ids,
    ignore_value outside this shard."""
    x = ins["X"][0]
    per = (attrs["index_num"] + attrs["nshards"] - 1) // attrs["nshards"]
    shard_id = attrs["shard_id"]
    return {"Out": [torch.where(
        torch.div(x, per, rounding_mode="floor") == shard_id,
        x - shard_id * per,
        torch.full_like(x, attrs.get("ignore_value", -1)))]}


@register_op("diag", not_differentiable=True, grad_free=True)
def _diag(ctx, ins, attrs):
    return {"Out": [torch.diag(ins["Diagonal"][0])]}


@register_op("cos_sim")
def _cos_sim(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn + 1e-12)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register_op("print")
def _print(ctx, ins, attrs):
    """Debug print (reference print_op.cc): X passes through; the line is
    the JAX rule's, "<message> shape=(..) mean=.. min=.. max=.. first=[..]"
    or, without print_tensor_stats, "<message> [..]" (the first
    `summarize` values)."""
    x = ins["X"][0]
    if ctx.abstract:
        return {"Out": [x]}
    msg = attrs.get("message", "")
    # through tolist: a replay under torch.func.vjp (the generic grad,
    # which prints again, as JAX's vjp replay does) has no storage to read
    first = np.array(x.reshape(-1)[:int(attrs.get("summarize", 20))]
                     .tolist(),
                     dtype=dtype_name(x.dtype))
    if x.numel() == 0:
        line = (msg + " shape={s} (empty)").format(s=str(tuple(x.shape)))
    elif attrs.get("print_tensor_stats", True):
        line = (msg + " shape={s} mean={m} min={mn} max={mx} first={f}") \
            .format(s=str(tuple(x.shape)),
                    m=np.float32(x.float().mean().item()),
                    mn=first.dtype.type(x.min().item()),
                    mx=first.dtype.type(x.max().item()), f=first)
    else:
        line = (msg + " {v}").format(v=first)
    print(line, flush=True)
    return {"Out": [x]}


@register_op("isnan", not_differentiable=True, grad_free=True)
def _isnan(ctx, ins, attrs):
    return {"Out": [torch.any(torch.isnan(ins["X"][0])).reshape((1,))]}


@register_op("isinf", not_differentiable=True, grad_free=True)
def _isinf(ctx, ins, attrs):
    return {"Out": [torch.any(torch.isinf(ins["X"][0])).reshape((1,))]}


@register_op("sign")
def _sign(ctx, ins, attrs):
    """reference: sign_op.cc; its gradient is zero (torch.sign's)."""
    return {"Out": [torch.sign(ins["X"][0])]}


# ---------------------------------------------------------------------------
# spatial rearrangement
# ---------------------------------------------------------------------------

@register_op("pixel_shuffle")
def _pixel_shuffle(ctx, ins, attrs):
    x = ins["X"][0]
    r = int(attrs["upscale_factor"])
    n, c, h, w = x.shape
    y = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": [y.reshape(n, c // (r * r), h * r, w * r)]}


@register_op("shuffle_channel")
def _shuffle_channel(ctx, ins, attrs):
    x = ins["X"][0]
    g = int(attrs["group"])
    n, c, h, w = x.shape
    y = x.reshape(n, g, c // g, h, w).permute(0, 2, 1, 3, 4)
    return {"Out": [y.reshape(n, c, h, w)]}


@register_op("space_to_depth")
def _space_to_depth(ctx, ins, attrs):
    x = ins["X"][0]
    b = int(attrs["blocksize"])
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return {"Out": [y.reshape(n, c * b * b, h // b, w // b)]}


@register_op("temporal_shift")
def _temporal_shift(ctx, ins, attrs):
    """reference temporal_shift_op.cc: shift 1/shift_ratio of channels one
    frame back/forward across the fold of N = nt/seg batches."""
    x = ins["X"][0]
    seg = int(attrs["seg_num"])
    ratio = attrs.get("shift_ratio", 0.25)
    nt, c, h, w = x.shape
    c1 = int(c * ratio)
    c2 = int(c * 2 * ratio)
    y = x.reshape(nt // seg, seg, c, h, w)
    fwd = torch.cat([y[:, 1:, :c1], torch.zeros_like(y[:, :1, :c1])], dim=1)
    bwd = torch.cat([torch.zeros_like(y[:, :1, c1:c2]), y[:, :-1, c1:c2]],
                    dim=1)
    out = torch.cat([fwd, bwd, y[:, :, c2:]], dim=2)
    return {"Out": [out.reshape(nt, c, h, w)]}


def _patches(x, ksize, strides, pad_pairs, dilations):
    """conv_general_dilated_patches (NCHW): [n, c*kh*kw, oh*ow], rows
    channel-major, read by advanced indexing of the zero-padded input."""
    kh, kw = (int(k) for k in ksize)
    sh, sw = (int(s) for s in strides)
    dh, dw = (int(d) for d in dilations)
    (pt, pb), (pl, pr) = pad_pairs
    xp = F.pad(x, (int(pl), int(pr), int(pt), int(pb)))
    n, c, hp, wp = xp.shape
    oh = (hp - dh * (kh - 1) - 1) // sh + 1
    ow = (wp - dw * (kw - 1) - 1) // sw + 1
    dev = x.device
    iy = torch.arange(kh, device=dev)[:, None] * dh \
        + torch.arange(oh, device=dev)[None, :] * sh         # [kh, oh]
    ix = torch.arange(kw, device=dev)[:, None] * dw \
        + torch.arange(ow, device=dev)[None, :] * sw         # [kw, ow]
    p = xp[:, :, iy[:, None, :, None], ix[None, :, None, :]]
    return p.reshape(n, c * kh * kw, oh * ow)


@register_op("unfold")
def _unfold(ctx, ins, attrs):
    """im2col (reference unfold_op.cc): [n,c,h,w] ->
    [n, c*kh*kw, out_h*out_w]. paddings: [ph, pw] symmetric, or the
    reference's 4-element [up, left, down, right]."""
    x = ins["X"][0]
    p = list(attrs.get("paddings", [0, 0]))
    if len(p) == 4:
        pad_pairs = [(p[0], p[2]), (p[1], p[3])]
    else:
        pad_pairs = [(p[0], p[0]), (p[1], p[1])]
    return {"Y": [_patches(x, attrs["kernel_sizes"],
                           attrs.get("strides", [1, 1]), pad_pairs,
                           attrs.get("dilations", [1, 1]))]}


@register_op("im2sequence")
def _im2sequence(ctx, ins, attrs):
    """reference im2sequence_op.cc: sliding patches flattened to a
    sequence [n, out_h*out_w, c*kh*kw]; paddings order matches unfold's
    [up, left, down, right]."""
    p = list(attrs.get("paddings", [0, 0, 0, 0]))
    pad_pairs = [(p[0], p[2]), (p[1], p[3])]
    y = _patches(ins["X"][0], attrs["kernels"],
                 attrs.get("strides", [1, 1]), pad_pairs, [1, 1])
    return {"Out": [y.transpose(1, 2)]}


# ---------------------------------------------------------------------------
# linalg helpers
# ---------------------------------------------------------------------------

@register_op("norm")
def _norm(ctx, ins, attrs):
    """l2-normalize along axis (reference norm_op.cc); Norm output is the
    per-slice norm."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    eps = attrs.get("epsilon", 1e-10)
    n = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True) + eps)
    return {"Out": [x / n], "Norm": [n]}


@register_op("dist")
def _dist(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    p = attrs.get("p", 2.0)
    d = x - y
    d = torch.where(d >= 0, d, -d)      # jnp.abs: slope 1 at 0
    if p == 0:
        out = torch.sum((d != 0).to(x.dtype))
    elif p == float("inf"):
        out = torch.amax(d)
    else:
        out = torch.sum(d ** p) ** (1.0 / p)
    return {"Out": [out.reshape((1,))]}


@register_op("cross", no_grad_inputs=set())
def _cross(ctx, ins, attrs):
    return {"Out": [torch.linalg.cross(ins["X"][0], ins["Y"][0],
                                       dim=attrs.get("dim", -1))]}


@register_op("kron")
def _kron(ctx, ins, attrs):
    return {"Out": [torch.kron(ins["X"][0], ins["Y"][0])]}


@register_op("trace")
def _trace(ctx, ins, attrs):
    return {"Out": [torch.diagonal(ins["Input"][0],
                                   offset=attrs.get("offset", 0),
                                   dim1=attrs.get("axis1", 0),
                                   dim2=attrs.get("axis2", 1)).sum(-1)]}


@register_op("meshgrid", not_differentiable=True, grad_free=True)
def _meshgrid(ctx, ins, attrs):
    return {"Out": [g.contiguous()
                    for g in torch.meshgrid(*ins["X"], indexing="ij")]}


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, ins, attrs):
    """reference bilinear_tensor_product_op.cc: out[b,k] =
    x[b,:] @ W[k] @ y[b,:] + bias."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]
    out = torch.einsum("bi,kij,bj->bk", x, w, y)
    if ins.get("Bias"):
        out = out + ins["Bias"][0]
    return {"Out": [out]}


# ---------------------------------------------------------------------------
# ranking losses
# ---------------------------------------------------------------------------

def _relu0(v):
    """jnp.maximum(0.0, v): its gradient at v == 0 is half, as JAX's."""
    return torch.maximum(torch.zeros_like(v), v)


def _softplus0(z):
    """jnp.logaddexp(0.0, z)."""
    return torch.logaddexp(torch.zeros_like(z), z)


@register_op("rank_loss", no_grad_inputs={"Label"})
def _rank_loss(ctx, ins, attrs):
    """reference rank_loss_op.cc (RankNet)."""
    label = ins["Label"][0]
    d = ins["Left"][0] - ins["Right"][0]
    return {"Out": [_softplus0(d) - label * d]}


@register_op("margin_rank_loss", no_grad_inputs={"Label"})
def _margin_rank_loss(ctx, ins, attrs):
    label = ins["Label"][0]
    x1, x2 = ins["X1"][0], ins["X2"][0]
    out = _relu0(-label * (x1 - x2) + attrs.get("margin", 0.0))
    return {"Out": [out], "Activated": [(out > 0).to(x1.dtype)]}


@register_op("bpr_loss", no_grad_inputs={"Label"})
def _bpr_loss(ctx, ins, attrs):
    """Bayesian personalized ranking (reference bpr_loss_op.cc): mean
    over the c-1 negatives of -log sigmoid(pos - x)."""
    x = ins["X"][0]                       # [b, c] scores
    label = ins["Label"][0].reshape(-1).long()
    b, c = x.shape
    pos = x[torch.arange(b, device=x.device), label][:, None]
    lsm = F.logsigmoid(pos - x)
    mask = torch.arange(c, device=x.device)[None, :] != label[:, None]
    loss = -torch.sum(lsm * mask, dim=1, keepdim=True) / float(c - 1)
    return {"Y": [loss]}


@register_op("hinge_loss", no_grad_inputs={"Labels"})
def _hinge_loss(ctx, ins, attrs):
    logits = ins["Logits"][0]
    y = ins["Labels"][0]
    return {"Loss": [_relu0(1.0 - (2.0 * y - 1.0) * logits)]}


@register_op("modified_huber_loss", no_grad_inputs={"Y"})
def _modified_huber_loss(ctx, ins, attrs):
    x = ins["X"][0]
    z = x * (2.0 * ins["Y"][0] - 1.0)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    loss = torch.where(z >= 1.0, zero,
                       torch.where(z >= -1.0, (1.0 - z) ** 2, -4.0 * z))
    return {"Out": [loss], "IntermediateVal": [z]}


@register_op("teacher_student_sigmoid_loss", no_grad_inputs={"Label"})
def _ts_sigmoid_loss(ctx, ins, attrs):
    """reference teacher_student_sigmoid_loss_op.cc (CTR distillation);
    the clip is jnp.clip's maximum-then-minimum."""
    x = ins["X"][0]
    label = ins["Label"][0]
    up = torch.full((), attrs.get("soft_max_up_bound", 15.0),
                    dtype=x.dtype, device=x.device)
    lo = torch.full((), attrs.get("soft_max_lower_bound", -15.0),
                    dtype=x.dtype, device=x.device)
    z = torch.minimum(torch.maximum(x, lo), up)
    hard = (label > 0.5).to(x.dtype)
    sp = _softplus0(z)
    return {"Y": [(sp - hard * z) + (sp - label * z)]}


@register_op("sampling_id", not_differentiable=True, grad_free=True,
             stateful=True)
def _sampling_id(ctx, ins, attrs):
    """Sample a column index per row from probabilities (reference
    sampling_id_op.cc): argmax of log(max(x, 1e-20)) plus Gumbel noise,
    jax.random.categorical's method, on the run's generator."""
    x = ins["X"][0]
    if ctx.abstract:
        return {"Out": [torch.empty(x.shape[:-1], dtype=torch.long,
                                    device=x.device)]}
    u = torch.rand(x.shape, generator=ctx.rng(), device=x.device)
    gumbel = -torch.log(-torch.log(u))
    logits = torch.log(torch.clamp_min(x.float(), 1e-20))
    return {"Out": [torch.argmax(logits + gumbel, dim=-1)]}
