"""Three ops of `paddle_tpu/ops/misc_ops.py`: add_position_encoding
(:118) and gather_tree (:322), which the NMT Transformer and the
beam-search decoders need, and log_loss (:277), DeepFM's loss. The rest of
that file comes with later slices.

add_position_encoding's and log_loss's grads take the generic vjp path;
gather_tree has none, as in JAX.
"""

import torch

from ..framework.registry import register_op


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
