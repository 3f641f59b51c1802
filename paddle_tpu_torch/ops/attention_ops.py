"""fused_attention program op (forward).

Port of `paddle_tpu/ops/attention_ops.py`. Inputs Q/K/V: (b, s, n, d);
BiasK (optional): (b, s_k) per-key additive. Attrs causal, sm_scale
(0 = 1/sqrt(d)), cp_axis, seq_parallel, impl. Outputs Out and Lse: on the
flash path Lse is the kernel's (b*n, sq) f32 row log-sum-exp, on the
reference path a dummy (1, 1).

At build time the rule runs on the meta device, where no kernel runs, so it
always takes the reference path there: the declared Lse shape is the dummy
(1, 1) even when the run-time Lse is (b*n, sq).

The grad maker is registered (same grad-op desc as the JAX package); the
grad lowering and context parallelism (ring / Ulysses over cp_axis) come
with later slices.
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


@register_op("fused_attention", no_grad_inputs={"BiasK"},
             non_diff_outputs={"Lse"},
             grad_maker=_fused_attention_grad_maker)
def _fused_attention(ctx, ins, attrs):
    from .flash_attention import attention_fwd_lse, mha_reference

    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    bias_k = ins.get("BiasK", [None])[0]
    causal = bool(attrs.get("causal", False))
    sm_scale = float(attrs.get("sm_scale", 0.0)) or None
    impl = attrs.get("impl", None) or None
    if attrs.get("cp_axis", ""):
        raise NotImplementedError(
            "fused_attention with cp_axis (ring / Ulysses context "
            "parallelism) is not ported to paddle_tpu_torch yet")
    dummy_lse = torch.zeros((1, 1), dtype=torch.float32, device=q.device)
    bias4 = bias_k[:, None, None, :] if bias_k is not None else None
    if q.device.type == "meta":
        out = mha_reference(q, k, v, bias4, causal, sm_scale)
        return {"Out": [out], "Lse": [dummy_lse]}
    out, lse = attention_fwd_lse(q, k, v, bias4, causal=causal,
                                 sm_scale=sm_scale, impl=impl)
    return {"Out": [out], "Lse": [lse if lse is not None else dummy_lse]}
