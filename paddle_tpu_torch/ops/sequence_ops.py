"""sequence_mask, the one op of `paddle_tpu/ops/sequence_ops.py` (:17) on
the NMT Transformer's and the book models' path: lengths -> a dense
[batch, maxlen] mask. The LoD-free sequence ops over the same dense
[batch, seq, ...] + lengths layout (pool, softmax, conv, ...) come with
ROADMAP A.6.
"""

import torch

from ..framework.registry import register_op, torch_dtype


@register_op("sequence_mask", not_differentiable=True, grad_free=True)
def _sequence_mask(ctx, ins, attrs):
    """reference: sequence_ops/sequence_mask_op.cc. maxlen must be static
    (the JAX rule's rule: the mask's shape is fixed when the program is
    built)."""
    x = ins["X"][0].reshape(-1)
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise ValueError("sequence_mask requires a static maxlen")
    steps = torch.arange(maxlen, device=x.device)
    mask = steps[None, :] < x[:, None]
    return {"Y": [mask.to(torch_dtype(attrs.get("out_dtype", "float32")))]}
