"""Optimizer update ops: sgd and adam, dense only.

Port of `paddle_tpu/ops/optimizer_ops.py` (sgd:30, adam:70). Each is a
function (param, grad, state...) -> (param', state...); the IR gives the
outputs the same var names as the inputs (ParamOut = Param, Moment1Out =
Moment1, ...), so the executor binds the new tensors to those names and
writes them back to the scope at the end of the run. State (moments) is
kept in float32 whatever the param dtype. SelectedRows (sparse) grads come
with the sparse lookup_table grad.
"""

import torch

from ..framework.registry import register_op


def _lr(ins):
    return ins["LearningRate"][0].reshape(()).float()


@register_op("sgd", not_differentiable=True, is_optimizer_op=True)
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    return {"ParamOut": [(p.float() - _lr(ins) * g.float()).to(p.dtype)]}


@register_op("adam", not_differentiable=True, is_optimizer_op=True)
def _adam(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = _lr(ins) * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    g32 = g.float()
    m1n = b1 * m1 + (1 - b1) * g32
    m2n = b2 * m2 + (1 - b2) * g32 * g32
    p_new = p.float() - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return {"ParamOut": [p_new.to(p.dtype)], "Moment1Out": [m1n],
            "Moment2Out": [m2n], "Beta1PowOut": [b1p * b1],
            "Beta2PowOut": [b2p * b2]}
