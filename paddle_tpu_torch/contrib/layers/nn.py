"""contrib nn layers (reference: python/paddle/fluid/contrib/layers/nn.py).

Port of `paddle_tpu/contrib/layers/nn.py` (a copy)."""

from __future__ import annotations

from ...framework.layer_helper import LayerHelper

__all__ = ["fused_elemwise_activation"]


def fused_elemwise_activation(x, y, functor_list, axis=-1, scale=0.0,
                              save_intermediate_out=True):
    """reference: contrib/layers/nn.py fused_elemwise_activation
    (fused/fused_elemwise_activation_op.cc) — f1(f2(x, y)) composition."""
    helper = LayerHelper("fused_elemwise_activation")
    out = helper.create_variable_for_type_inference(x.dtype)
    intermediate = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fused_elemwise_activation",
                     {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name],
                      "IntermediateOut": [intermediate.name]},
                     {"functor_list": list(functor_list),
                      "axis": int(axis), "scale": float(scale),
                      "save_intermediate_out": bool(save_intermediate_out)})
    return out
