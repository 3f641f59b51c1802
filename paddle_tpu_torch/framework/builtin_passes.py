"""Built-in passes registered through the generic PassRegistry.

Port of `paddle_tpu/framework/builtin_passes.py` (a copy): the AMP and
quantization rewrites as named passes, and the pattern-based fuse pass
the reference ships as ir/fuse_elewise_add_act_pass.cc, which appends the
fused_elemwise_activation op type (`ops/fused_ops.py`).
"""

from __future__ import annotations

from .core import unique_name
from .passes import (Pattern, PatternPass, register_pass, replace_ops)

_ACT_TYPES = ("relu", "sigmoid", "tanh", "scale")


@register_pass("fuse_elewise_add_act")
class FuseElewiseAddActPass(PatternPass):
    """elementwise_add -> {relu|sigmoid|tanh|scale} becomes ONE
    fused_elemwise_activation op (reference:
    ir/fuse_elewise_add_act_pass.cc:36)."""

    act = "relu"

    def build_pattern(self, p: Pattern):
        add = p.op("elementwise_add")
        p.op(self.act, inputs={"X": add.out("Out")})

    def rewrite(self, block, match):
        add_op, act_op = match.ops
        inter = unique_name("fuse_add_act.inter")
        block.create_var(name=inter, dtype=None, stop_gradient=False)
        replace_ops(block, [add_op, act_op], [{
            "type": "fused_elemwise_activation",
            "inputs": {"X": add_op.inputs["X"],
                       "Y": add_op.inputs["Y"]},
            "outputs": {"Out": act_op.outputs["Out"],
                        "IntermediateOut": [inter]},
            "attrs": {"functor_list": [self.act, "elementwise_add"],
                      "axis": add_op.attrs.get("axis", -1),
                      "scale": act_op.attrs.get("scale", 0.0),
                      "save_intermediate_out": False},
        }])


@register_pass("amp_bf16_rewrite")
def _amp_pass(program, **kw):
    """Wraps contrib.mixed_precision.rewrite_bf16 (the AMP cast-insertion
    rewrite) as a registry pass."""
    from ..contrib.mixed_precision import rewrite_bf16
    rewrite_bf16(program, **kw)
    return program


@register_pass("quant_transform")
def _quant_transform_pass(program, startup=None, **kw):
    """Wraps slim QuantizationTransformPass (QAT fake-quant insertion)."""
    from ..contrib.slim.quantization import QuantizationTransformPass
    QuantizationTransformPass(**kw).apply(program, startup)
    return program


@register_pass("quant_freeze")
def _quant_freeze_pass(program, scope=None, **kw):
    """Wraps slim QuantizationFreezePass (fold trained quant params)."""
    from ..contrib.slim.quantization import QuantizationFreezePass
    return QuantizationFreezePass(**kw).apply(program, scope)
