"""Optimizer update ops: every update op of the JAX package.

Port of `paddle_tpu/ops/optimizer_ops.py` (sgd:30, momentum:43, adam:70,
adamw:104, adagrad:126, decayed_adagrad:145, adadelta:156, adamax:171,
rmsprop:188, lamb:212, lars_momentum:238, ftrl:254, proximal_gd:284,
proximal_adagrad:294, dgc:308, dgc_gather:337). Each is a function
(param, grad, state...) -> (param', state...); the IR gives the outputs
the same var names as the inputs (ParamOut = Param, Moment1Out = Moment1,
...). Where the executor donates an input (`ctx.inplace` names its slot:
a state var it bound in the scope itself, see framework/executor.py), the
rule writes the new value into that tensor's storage with the same
arithmetic, op for op, as the out-of-place form, so both give the same
bits; elsewhere it returns new tensors, which the executor binds to the
names. Every value a rule reads from a donated input is read before that
input is written. State (moments, velocities) is kept in float32 whatever
the param dtype.

SelectedRows (sparse) grads: sgd scatter-adds the rows (duplicates add
once each); momentum, adam, adamw and adagrad first merge duplicate rows
and then scatter-set the touched rows only (the reference's lazy sparse
kernels; the beta pows still advance); every other op densifies the grad,
as the reference registers only a dense kernel for it.
"""

import torch

from ..framework.registry import register_op
from ..framework.selected_rows import SelectedRows, merge_rows, scatter_add


def _lr(ins):
    return ins["LearningRate"][0].reshape(()).float()


def _dense_grad(ins):
    """The grad of an op without a sparse kernel, densified."""
    g = ins["Grad"][0]
    return g.to_dense() if isinstance(g, SelectedRows) else g


def _scaled(ctx, slot, t, beta):
    """t * beta, written into t when the executor donated `slot`."""
    return t.mul_(beta) if slot in ctx.inplace else t * beta


def _scaled_add(ctx, slot, t, beta, inc):
    """beta * t + inc, written into t when the executor donated `slot`."""
    if slot in ctx.inplace:
        return t.mul_(beta).add_(inc)
    return beta * t + inc


def _plus(ctx, slot, t, inc):
    """t + inc, written into t when the executor donated `slot`."""
    return t.add_(inc) if slot in ctx.inplace else t + inc


def _store(ctx, slot, t, new):
    """`new` (computed out of place) as the value of `slot`: copied into t
    when the executor donated it, so the two forms hold the same bits."""
    return t.copy_(new) if slot in ctx.inplace else new


def _set_rows(ctx, slot, t, rows, vals):
    """t with rows `rows` set to vals (cast to t's dtype), written into t
    when the executor donated `slot`. Merged duplicates write the same
    value, so the order of the writes does not matter."""
    vals = vals.to(t.dtype)
    if slot in ctx.inplace:
        return t.index_put_((rows,), vals)
    return t.index_put((rows,), vals)


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
    if isinstance(g, SelectedRows):
        # touch only the rows that appeared (reference: optimizers/
        # sgd_op.h SelectedRows branch); a scatter-add takes duplicates
        upd = (-_lr(ins) * g.values.float()).to(p.dtype)
        return {"ParamOut": [scatter_add(p, g.rows, upd,
                                         inplace="Param" in ctx.inplace)]}
    return {"ParamOut": [_param_step(ctx, p, _lr(ins) * g.float())]}


@register_op("momentum", not_differentiable=True, is_optimizer_op=True)
def _momentum(ctx, ins, attrs):
    """v' = mu * v + g; p' = p - lr * v', or with Nesterov p - lr * (g +
    mu * v'); in f32, ParamOut cast back to the parameter's dtype. A
    SelectedRows grad updates its merged rows only."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = attrs["mu"]
    lr = _lr(ins)
    nesterov = attrs.get("use_nesterov", False)
    if isinstance(g, SelectedRows):
        g = merge_rows(g)
        rows = g.rows
        g32 = g.values.float()
        v_r = mu * v[rows] + g32
        if nesterov:
            p_r = p[rows].float() - (g32 + mu * v_r) * lr
        else:
            p_r = p[rows].float() - lr * v_r
        return {"ParamOut": [_set_rows(ctx, "Param", p, rows, p_r)],
                "VelocityOut": [_set_rows(ctx, "Velocity", v, rows, v_r)]}
    g32 = g.float()
    v_new = _scaled_add(ctx, "Velocity", v, mu, g32)
    if nesterov:
        upd = (g32 + mu * v_new) * lr
    else:
        upd = lr * v_new
    return {"ParamOut": [_param_step(ctx, p, upd)], "VelocityOut": [v_new]}


def _beta_pows(ctx, ins, b1, b2):
    return {"Beta1PowOut": [_scaled(ctx, "Beta1Pow", ins["Beta1Pow"][0], b1)],
            "Beta2PowOut": [_scaled(ctx, "Beta2Pow", ins["Beta2Pow"][0],
                                    b2)]}


@register_op("adam", not_differentiable=True, is_optimizer_op=True)
def _adam(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = _lr(ins) * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    if isinstance(g, SelectedRows):
        # lazy sparse adam (reference: optimizers/adam_op.h SelectedRows
        # branch): moments and param move on the touched rows only
        g = merge_rows(g)
        rows = g.rows
        g32 = g.values.float()
        m1_r = b1 * m1[rows] + (1 - b1) * g32
        m2_r = b2 * m2[rows] + (1 - b2) * g32 * g32
        p_r = p[rows].float() - lr_t * m1_r / (torch.sqrt(m2_r) + eps)
        return {"ParamOut": [_set_rows(ctx, "Param", p, rows, p_r)],
                "Moment1Out": [_set_rows(ctx, "Moment1", m1, rows, m1_r)],
                "Moment2Out": [_set_rows(ctx, "Moment2", m2, rows, m2_r)],
                **_beta_pows(ctx, ins, b1, b2)}
    g32 = g.float()
    m1n = _scaled_add(ctx, "Moment1", m1, b1, (1 - b1) * g32)
    m2n = _scaled_add(ctx, "Moment2", m2, b2, (1 - b2) * g32 * g32)
    p_new = _param_step(ctx, p, lr_t * m1n / (torch.sqrt(m2n) + eps))
    return {"ParamOut": [p_new], "Moment1Out": [m1n], "Moment2Out": [m2n],
            **_beta_pows(ctx, ins, b1, b2)}


@register_op("adamw", not_differentiable=True, is_optimizer_op=True)
def _adamw(ctx, ins, attrs):
    """adam, then p' -= lr * coeff * p (the parameter before the step); a
    SelectedRows grad decays its touched rows only."""
    p, g = ins["Param"][0], ins["Grad"][0]
    coeff = attrs.get("coeff", 0.01)
    decay = None
    if attrs.get("with_decay", True):
        lr = _lr(ins)
        # read from p before adam may write it in place
        if isinstance(g, SelectedRows):
            decay = lr * coeff * p[g.rows].float()
        else:
            decay = lr * coeff * p.float()
    outs = _adam(ctx, ins, attrs)
    if decay is not None:
        po = outs["ParamOut"][0]
        if isinstance(g, SelectedRows):
            outs["ParamOut"] = [_set_rows(ctx, "Param", po, g.rows,
                                          po[g.rows].float() - decay)]
        else:
            outs["ParamOut"] = [_param_step(ctx, po, decay)]
    return outs


@register_op("adagrad", not_differentiable=True, is_optimizer_op=True)
def _adagrad(ctx, ins, attrs):
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    eps = attrs.get("epsilon", 1e-6)
    if isinstance(g, SelectedRows):
        g = merge_rows(g)
        rows = g.rows
        g32 = g.values.float()
        mom_r = mom[rows] + g32 * g32
        p_r = p[rows].float() - _lr(ins) * g32 / (torch.sqrt(mom_r) + eps)
        return {"ParamOut": [_set_rows(ctx, "Param", p, rows, p_r)],
                "MomentOut": [_set_rows(ctx, "Moment", mom, rows, mom_r)]}
    g32 = g.float()
    mom_new = _plus(ctx, "Moment", mom, g32 * g32)
    p_new = _param_step(ctx, p, _lr(ins) * g32 / (torch.sqrt(mom_new) + eps))
    return {"ParamOut": [p_new], "MomentOut": [mom_new]}


@register_op("decayed_adagrad", not_differentiable=True, is_optimizer_op=True)
def _decayed_adagrad(ctx, ins, attrs):
    p, g, mom = ins["Param"][0], _dense_grad(ins), ins["Moment"][0]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g32 = g.float()
    mom_new = _scaled_add(ctx, "Moment", mom, decay, (1 - decay) * g32 * g32)
    p_new = _param_step(ctx, p, _lr(ins) * g32 / (torch.sqrt(mom_new) + eps))
    return {"ParamOut": [p_new], "MomentOut": [mom_new]}


@register_op("adadelta", not_differentiable=True, is_optimizer_op=True)
def _adadelta(ctx, ins, attrs):
    p, g = ins["Param"][0], _dense_grad(ins)
    avg_sq, avg_upd = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g32 = g.float()
    sq_new = _scaled_add(ctx, "AvgSquaredGrad", avg_sq, rho,
                         (1 - rho) * g32 * g32)
    upd = torch.sqrt(avg_upd + eps) / torch.sqrt(sq_new + eps) * g32
    upd_new = _scaled_add(ctx, "AvgSquaredUpdate", avg_upd, rho,
                          (1 - rho) * upd * upd)
    return {"ParamOut": [_param_step(ctx, p, _lr(ins) * upd)],
            "AvgSquaredGradOut": [sq_new], "AvgSquaredUpdateOut": [upd_new]}


@register_op("adamax", not_differentiable=True, is_optimizer_op=True)
def _adamax(ctx, ins, attrs):
    """Beta1Pow is read, not advanced: AdamaxOptimizer appends a scale
    op for it after every update (its _finish_update)."""
    p, g = ins["Param"][0], _dense_grad(ins)
    m, inf = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    g32 = g.float()
    m_new = _scaled_add(ctx, "Moment", m, b1, (1 - b1) * g32)
    inf_new = _store(ctx, "InfNorm", inf,
                     torch.maximum(b2 * inf, torch.abs(g32)))
    lr_t = _lr(ins) / (1 - b1p.reshape(()))
    p_new = _param_step(ctx, p, lr_t * m_new / (inf_new + eps))
    return {"ParamOut": [p_new], "MomentOut": [m_new],
            "InfNormOut": [inf_new]}


@register_op("rmsprop", not_differentiable=True, is_optimizer_op=True)
def _rmsprop(ctx, ins, attrs):
    p, g = ins["Param"][0], _dense_grad(ins)
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    lr = _lr(ins)
    g32 = g.float()
    ms_new = _scaled_add(ctx, "MeanSquare", ms, rho, (1 - rho) * g32 * g32)
    outs = {}
    if attrs.get("centered", False):
        mg_new = _scaled_add(ctx, "MeanGrad", ins["MeanGrad"][0], rho,
                             (1 - rho) * g32)
        denom = torch.sqrt(ms_new - mg_new * mg_new + eps)
        outs["MeanGradOut"] = [mg_new]
    else:
        denom = torch.sqrt(ms_new + eps)
    mom_new = _scaled_add(ctx, "Moment", mom, mu, lr * g32 / denom)
    outs.update({"ParamOut": [_param_step(ctx, p, mom_new)],
                 "MeanSquareOut": [ms_new], "MomentOut": [mom_new]})
    return outs


@register_op("lamb", not_differentiable=True, is_optimizer_op=True)
def _lamb(ctx, ins, attrs):
    """reference: optimizers/lamb_op.cc, the layer-adaptive large-batch
    optimizer: the Adam direction plus weight decay, scaled by the trust
    ratio ||p|| / ||r|| (1 where either norm is 0; the division is taken
    on a safe denominator, so the branch not taken holds no inf or NaN)."""
    p, g = ins["Param"][0], _dense_grad(ins)
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    g32 = g.float()
    p32 = p.float()
    m1n = _scaled_add(ctx, "Moment1", m1, b1, (1 - b1) * g32)
    m2n = _scaled_add(ctx, "Moment2", m2, b2, (1 - b2) * g32 * g32)
    m1h = m1n / (1 - b1p.reshape(()))
    m2h = m2n / (1 - b2p.reshape(()))
    r = m1h / (torch.sqrt(m2h) + eps) + wd * p32
    p_norm = torch.sqrt(torch.sum(p32 * p32))
    r_norm = torch.sqrt(torch.sum(r * r))
    ok = (p_norm > 0) & (r_norm > 0)
    trust = torch.where(ok, p_norm / torch.where(ok, r_norm, 1.0), 1.0)
    p_new = _param_step(ctx, p, _lr(ins) * trust * r)
    return {"ParamOut": [p_new], "Moment1Out": [m1n], "Moment2Out": [m2n],
            **_beta_pows(ctx, ins, b1, b2)}


@register_op("lars_momentum", not_differentiable=True, is_optimizer_op=True)
def _lars_momentum(ctx, ins, attrs):
    p, g, v = ins["Param"][0], _dense_grad(ins), ins["Velocity"][0]
    mu = attrs["mu"]
    coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    g32 = g.float()
    p32 = p.float()
    p_norm = torch.sqrt(torch.sum(p32 * p32))
    g_norm = torch.sqrt(torch.sum(g32 * g32))
    local_lr = _lr(ins) * coeff * p_norm / (g_norm + wd * p_norm + 1e-12)
    v_new = _scaled_add(ctx, "Velocity", v, mu, local_lr * (g32 + wd * p32))
    return {"ParamOut": [_param_step(ctx, p, v_new)], "VelocityOut": [v_new]}


@register_op("ftrl", not_differentiable=True, is_optimizer_op=True)
def _ftrl(ctx, ins, attrs):
    """FTRL-proximal. Its accumulator outs are named SquaredAccumOut and
    LinearAccumOut (not <slot>Out), so the executor never donates them."""
    p, g = ins["Param"][0], _dense_grad(ins)
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    lr = _lr(ins)
    g32 = g.float()
    new_sq = sq + g32 * g32
    sigma = (new_sq ** -power - sq ** -power) / lr
    lin_new = lin + g32 - sigma * p.float()
    pre = torch.where(torch.abs(lin_new) > l1,
                      l1 * torch.sign(lin_new) - lin_new, 0.0)
    denom = new_sq ** -power / lr + 2 * l2
    p_new = _store(ctx, "Param", p, (pre / denom).to(p.dtype))
    return {"ParamOut": [p_new], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [lin_new]}


def _soft_threshold(prox, lr, l1, l2):
    """Proximal step shared by proximal_gd/proximal_adagrad (reference:
    optimizers/proximal_gd_op.h): soft-threshold by lr*l1, shrink by
    1/(1+lr*l2)."""
    if l1 > 0:
        return (torch.sign(prox) * torch.clamp_min(torch.abs(prox) - lr * l1,
                                                   0.0)
                / (1.0 + lr * l2))
    return prox / (1.0 + lr * l2)


@register_op("proximal_gd", not_differentiable=True, is_optimizer_op=True)
def _proximal_gd(ctx, ins, attrs):
    """reference: optimizers/proximal_gd_op.cc"""
    p, g = ins["Param"][0], _dense_grad(ins)
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    lr = _lr(ins)
    prox = p.float() - lr * g.float()
    return {"ParamOut": [_store(ctx, "Param", p, _soft_threshold(
        prox, lr, l1, l2).to(p.dtype))]}


@register_op("proximal_adagrad", not_differentiable=True,
             is_optimizer_op=True)
def _proximal_adagrad(ctx, ins, attrs):
    """reference: optimizers/proximal_adagrad_op.cc"""
    p, g, m = ins["Param"][0], _dense_grad(ins), ins["Moment"][0]
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    lr = _lr(ins)
    g32 = g.float()
    m_new = _plus(ctx, "Moment", m, g32 * g32)
    prox = p.float() - lr * g32 / torch.sqrt(m_new)
    return {"ParamOut": [_store(ctx, "Param", p, _soft_threshold(
        prox, lr, l1, l2).to(p.dtype))], "MomentOut": [m_new]}


@register_op("dgc", not_differentiable=True, is_optimizer_op=True)
def _dgc(ctx, ins, attrs):
    """Deep Gradient Compression (reference: operators/dgc_op.cc +
    DGCMomentumOptimizer optimizer.py:787): momentum correction (U), error
    feedback (V), top-k sparsification. Out is a SelectedRows over the
    FLATTENED gradient ([numel, 1], rows = element indices). torch.topk
    may order exact ties otherwise than jax.lax.top_k; at sparsity 0
    every element is sent either way."""
    u, v = ins["U"][0], ins["V"][0]
    mu = attrs.get("momentum", 0.9)
    sparsity = attrs.get("sparsity", 0.999)
    g32 = _dense_grad(ins).float().reshape(-1)
    numel = g32.shape[0]
    k = max(1, int(numel * (1.0 - sparsity)))
    u_new = mu * u.reshape(-1) + g32
    v_new = v.reshape(-1) + u_new
    _, idx = torch.topk(torch.abs(v_new), k)
    vals = v_new[idx]
    # error feedback: clear what was sent; momentum factor masking
    v_out = v_new.index_fill(0, idx, 0.0)
    u_out = u_new.index_fill(0, idx, 0.0)
    return {"Out": [SelectedRows(idx, vals[:, None], numel)],
            "UOut": [_store(ctx, "U", u, u_out.reshape(u.shape))],
            "VOut": [_store(ctx, "V", v, v_out.reshape(v.shape))]}


@register_op("dgc_gather", not_differentiable=True, is_optimizer_op=True)
def _dgc_gather(ctx, ins, attrs):
    """Densify the sparse DGC gradient back to the parameter's shape for
    the update op."""
    x = ins["X"][0]
    if isinstance(x, SelectedRows):
        x = x.to_dense()
    return {"Out": [x.reshape(tuple(attrs["shape"]))]}
