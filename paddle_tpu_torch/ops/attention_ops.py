"""fused_attention program op and its gradient.

Port of `paddle_tpu/ops/attention_ops.py`. Inputs Q/K/V: (b, s, n, d);
BiasK (optional): (b, s_k) per-key additive. Attrs causal, sm_scale
(0 = 1/sqrt(d)), cp_axis, seq_parallel, impl. Outputs Out and Lse: on the
flash path Lse is the kernel's (b*n, sq) f32 row log-sum-exp, on the
reference path a dummy (1, 1).

At build time the rule runs on the meta device, where no kernel runs, so it
always takes the reference path there: the declared Lse shape is the dummy
(1, 1) even when the run-time Lse is (b*n, sq).

The grad maker emits the JAX package's grad-op desc. Its lowering
(`_fused_attention_grad_lower`, JAX :47-85) drives the flash backward
kernels from the saved Out and Lse on the flash path (no forward replay),
and replays the reference through torch.func.vjp on the plain path.
Context parallelism (ring / Ulysses over cp_axis) comes with a later slice.
"""

import torch

from ..framework.registry import register_op

__all__ = []


def _fused_attention_grad_maker(op, block, no_grad_set):
    from ..framework.core import grad_var_name
    ins = {"Q": op.input("Q"), "K": op.input("K"), "V": op.input("V"),
           "Out": op.output("Out"), "Lse": op.output("Lse"),
           "Out@GRAD": [grad_var_name(op.output("Out")[0])]}
    if op.input("BiasK"):
        ins["BiasK"] = op.input("BiasK")
    return [{
        "type": "fused_attention_grad",
        "inputs": ins,
        "outputs": {"Q@GRAD": [grad_var_name(op.input("Q")[0])],
                    "K@GRAD": [grad_var_name(op.input("K")[0])],
                    "V@GRAD": [grad_var_name(op.input("V")[0])]},
        "attrs": dict(op.attrs),
    }]


def _check_cp(attrs):
    if attrs.get("cp_axis", ""):
        raise NotImplementedError(
            "fused_attention with cp_axis (ring / Ulysses context "
            "parallelism) is not ported to paddle_tpu_torch yet")


def _fused_attention_grad_lower(ctx, ins, attrs):
    """Flash path: the backward kernels from the saved Out + Lse. Plain
    path: torch.func.vjp over the reference forward."""
    from .flash_attention import attention_bwd_saved, flash_dispatch

    _check_cp(attrs)
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    bias_k = ins.get("BiasK", [None])[0]
    out, lse = ins["Out"][0], ins["Lse"][0]
    g = ins["Out@GRAD"][0].to(out.dtype)
    causal = bool(attrs.get("causal", False))
    sm_scale = float(attrs.get("sm_scale", 0.0)) or None
    impl = attrs.get("impl", None) or None
    bias4 = bias_k[:, None, None, :] if bias_k is not None else None

    if flash_dispatch(q, k, bias4, impl)[0]:
        dq, dk, dv = attention_bwd_saved(q, k, v, bias4, out, lse, g, causal,
                                         sm_scale, impl)
        return {"Q@GRAD": [dq], "K@GRAD": [dk], "V@GRAD": [dv]}

    def f(q_, k_, v_):
        fwd_ins = {"Q": [q_], "K": [k_], "V": [v_]}
        if bias_k is not None:
            fwd_ins["BiasK"] = [bias_k]
        return _fused_attention(ctx, fwd_ins, attrs)["Out"][0]

    _, vjp_fn = torch.func.vjp(f, q, k, v)
    dq, dk, dv = vjp_fn(g)
    return {"Q@GRAD": [dq], "K@GRAD": [dk], "V@GRAD": [dv]}


@register_op("fused_attention", no_grad_inputs={"BiasK"},
             non_diff_outputs={"Lse"},
             grad_maker=_fused_attention_grad_maker,
             grad_lower=_fused_attention_grad_lower)
def _fused_attention(ctx, ins, attrs):
    from .flash_attention import attention_fwd_lse, mha_reference

    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    bias_k = ins.get("BiasK", [None])[0]
    causal = bool(attrs.get("causal", False))
    sm_scale = float(attrs.get("sm_scale", 0.0)) or None
    impl = attrs.get("impl", None) or None
    _check_cp(attrs)
    dummy_lse = torch.zeros((1, 1), dtype=torch.float32, device=q.device)
    bias4 = bias_k[:, None, None, :] if bias_k is not None else None
    if q.device.type == "meta":
        out = mha_reference(q, k, v, bias4, causal, sm_scale)
        return {"Out": [out], "Lse": [dummy_lse]}
    out, lse = attention_fwd_lse(q, k, v, bias4, causal=causal,
                                 sm_scale=sm_scale, impl=impl)
    return {"Out": [out], "Lse": [lse if lse is not None else dummy_lse]}
