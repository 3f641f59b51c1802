"""is_empty, the one op of `paddle_tpu/ops/extra_ops.py` (:141) that the
control-flow slice's layers append (`layers.is_empty`). The rest of that
file comes with ROADMAP A.4b/A.7."""

import torch

from ..framework.registry import register_op


@register_op("is_empty", not_differentiable=True, grad_free=True)
def _is_empty(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.tensor([x.numel() == 0], device=x.device)]}
