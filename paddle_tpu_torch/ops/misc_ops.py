"""Ops of `paddle_tpu/ops/misc_ops.py`: add_position_encoding (:118) and
gather_tree (:322), which the NMT Transformer and the beam-search
decoders need; log_loss (:277), DeepFM's loss; and those the layer files
append: linspace (:140), shard_index (:152), diag (:210), cos_sim (:236),
print (:355), isnan (:384), isinf (:389) and sign (:394, the JAX
registry's final, differentiable rule). The rest of that file comes with
later slices.

The grads of add_position_encoding, log_loss, cos_sim and sign take the
generic vjp path; gather_tree, linspace, shard_index, diag, isnan and
isinf have none, as in JAX. print passes X through and writes one line to
stdout in jax.debug.print's format (numpy's scalar and array formatting);
on the card that reads the values back (a synchronisation a call).
"""

import numpy as np
import torch

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
