"""Optimizer update ops: sgd, momentum and adam, dense only.

Port of `paddle_tpu/ops/optimizer_ops.py` (sgd:30, momentum:43, adam:70).
Each is a function (param, grad, state...) -> (param', state...); the IR
gives the outputs the same var names as the inputs (ParamOut = Param,
Moment1Out = Moment1, ...). Where the executor donates an input
(`ctx.inplace` names its slot: a state var it bound in the scope itself,
see framework/executor.py), the rule writes the new value into that
tensor's storage with the same arithmetic, op for op, as the out-of-place
form, so both give the same bits; elsewhere it returns new tensors, which
the executor binds to the names. State (moments, velocities) is kept in
float32 whatever the param dtype.
SelectedRows (sparse) grads come with the sparse lookup_table grad; until
then momentum raises on one.
"""

import torch

from ..framework.registry import register_op


def _lr(ins):
    return ins["LearningRate"][0].reshape(()).float()


def _scaled(ctx, slot, t, beta):
    """t * beta, written into t when the executor donated `slot`."""
    return t.mul_(beta) if slot in ctx.inplace else t * beta


def _scaled_add(ctx, slot, t, beta, inc):
    """beta * t + inc, written into t when the executor donated `slot`."""
    if slot in ctx.inplace:
        return t.mul_(beta).add_(inc)
    return beta * t + inc


def _param_step(ctx, p, upd):
    """p - upd in f32, cast back to p's dtype; written into p when the
    executor donated it."""
    if "Param" not in ctx.inplace:
        return (p.float() - upd).to(p.dtype)
    if p.dtype == torch.float32:
        return p.sub_(upd)
    return p.copy_((p.float() - upd).to(p.dtype))


@register_op("sgd", not_differentiable=True, is_optimizer_op=True)
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    return {"ParamOut": [_param_step(ctx, p, _lr(ins) * g.float())]}


@register_op("momentum", not_differentiable=True, is_optimizer_op=True)
def _momentum(ctx, ins, attrs):
    """v' = mu * v + g; p' = p - lr * v', or with Nesterov p - lr * (g +
    mu * v'); in f32, ParamOut cast back to the parameter's dtype."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    if not isinstance(g, torch.Tensor):
        raise NotImplementedError(
            "momentum with a SelectedRows grad is not ported to "
            "paddle_tpu_torch yet (ROADMAP A.5)")
    mu = attrs["mu"]
    lr = _lr(ins)
    g32 = g.float()
    v_new = _scaled_add(ctx, "Velocity", v, mu, g32)
    if attrs.get("use_nesterov", False):
        upd = (g32 + mu * v_new) * lr
    else:
        upd = lr * v_new
    return {"ParamOut": [_param_step(ctx, p, upd)], "VelocityOut": [v_new]}


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
    m1n = _scaled_add(ctx, "Moment1", m1, b1, (1 - b1) * g32)
    m2n = _scaled_add(ctx, "Moment2", m2, b2, (1 - b2) * g32 * g32)
    p_new = _param_step(ctx, p, lr_t * m1n / (torch.sqrt(m2n) + eps))
    return {"ParamOut": [p_new], "Moment1Out": [m1n], "Moment2Out": [m2n],
            "Beta1PowOut": [_scaled(ctx, "Beta1Pow", b1p, b1)],
            "Beta2PowOut": [_scaled(ctx, "Beta2Pow", b2p, b2)]}
