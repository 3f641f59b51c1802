"""LayerHelper: shared machinery for layers DSL functions.

Reference: python/paddle/fluid/layer_helper.py — creates parameters (with
their init ops in the startup program), temp output vars, and applies
activations/bias.
"""

from __future__ import annotations

from typing import Optional

from .core import (default_main_program, default_startup_program,
                   unique_name, Variable)

__all__ = ["LayerHelper", "ParamAttr"]


class ParamAttr:
    """reference: python/paddle/fluid/param_attr.py"""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        raise TypeError(f"bad param_attr {attr!r}")


class WeightNormParamAttr(ParamAttr):
    """Weight-normalized parameter (reference: param_attr.py
    WeightNormParamAttr): the layer's weight is reparameterized as
    w = g * v / ||v|| with direction v and magnitude g trained separately;
    `dim` is the output dimension kept un-normalized (None = whole-tensor
    norm). LayerHelper.create_parameter builds the reparam graph."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 gradient_clip=None):
        super().__init__(name=name, initializer=initializer,
                         learning_rate=learning_rate,
                         regularizer=regularizer, trainable=trainable)
        self.dim = dim
        self.gradient_clip = gradient_clip


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs
        self.name = kwargs.get("name") or unique_name(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_parameter(self, attr, shape, dtype="float32",
                         is_bias: bool = False, default_initializer=None):
        from ..initializer import Constant, Xavier
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if isinstance(attr, WeightNormParamAttr):
            return self._weight_norm_parameter(attr, shape, dtype, is_bias,
                                               default_initializer)
        name = attr.name or unique_name(f"{self.name}.w"
                                        if not is_bias else f"{self.name}.b")
        init = attr.initializer or default_initializer or (
            Constant(0.0) if is_bias else Xavier())
        # shared param (a named ParamAttr reused across layers, e.g. a
        # tied embedding): return the existing Parameter instead of
        # re-creating it — re-creating also re-appended its init op, so
        # the startup program initialized the same param N times (dead
        # writes, flagged by the verifier as PT-W103)
        existing = self.main_program.global_block.vars.get(name)
        if existing is not None:
            from .core import Parameter
            if not isinstance(existing, Parameter):
                raise ValueError(
                    f"var {name!r} already exists and is not a Parameter")
            if tuple(existing.shape) != tuple(shape):
                raise ValueError(
                    f"shared parameter {name!r} redefined with shape "
                    f"{list(shape)} != existing {list(existing.shape)}")
            from .core import convert_np_dtype
            if existing.dtype != convert_np_dtype(dtype):
                raise ValueError(
                    f"shared parameter {name!r} redefined with dtype "
                    f"{dtype!r} != existing {existing.dtype!r}")
            if existing.trainable != attr.trainable:
                raise ValueError(
                    f"shared parameter {name!r} redefined with "
                    f"trainable={attr.trainable} != existing "
                    f"trainable={existing.trainable}")
            # initializer / regularizer / learning_rate: first definition
            # wins (the shared-ParamAttr contract — one param, one init)
            return existing
        # parameters always live in the GLOBAL block, even when the layer
        # is built inside a control-flow sub-block (reference framework.py:
        # Parameter is global-block-bound) — sub-block vars are loop-local
        # and would not be seeded from the scope
        param = self.main_program.global_block.create_parameter(
            name=name, shape=shape, dtype=dtype, trainable=attr.trainable,
            regularizer=attr.regularizer)
        param.optimize_attrs["learning_rate"] = attr.learning_rate
        sb = self.startup_program.global_block
        sb.create_var(name=name, shape=shape, dtype=dtype, persistable=True,
                      stop_gradient=True)
        init(param, sb)
        return param

    def _weight_norm_parameter(self, attr, shape, dtype, is_bias,
                               default_initializer):
        """w = g * v / ||v||: v (direction) and g (magnitude) are the
        trainable params; the returned var is the recomputed weight
        (reference helper.py _create_weight_normalize)."""
        from ..initializer import Constant
        base = attr.name or unique_name(
            f"{self.name}.w" if not is_bias else f"{self.name}.b")
        v = self.create_parameter(
            ParamAttr(name=base + ".v", initializer=attr.initializer,
                      learning_rate=attr.learning_rate,
                      regularizer=attr.regularizer,
                      trainable=attr.trainable),
            shape, dtype, is_bias, default_initializer)
        dim = attr.dim
        if dim is not None:
            gshape = [shape[i] if i == dim else 1 for i in
                      range(len(shape))]
            axes = [i for i in range(len(shape)) if i != dim]
            reduce_attrs = {"dim": axes, "keep_dim": True}
        else:
            gshape = [1] * len(shape)
            reduce_attrs = {"reduce_all": True, "keep_dim": True}
        g = self.create_parameter(
            ParamAttr(name=base + ".g", initializer=Constant(1.0),
                      learning_rate=attr.learning_rate,
                      trainable=attr.trainable),
            gshape, dtype)
        # Reconstruct g = ||v|| in the startup program so the initial
        # weight w = g*v/||v|| equals the requested initializer's draw
        # (reference layer_helper_base.py:243 norm_except_dim init).
        sb = self.startup_program.global_block

        def sop(op_type, ins, out_name=None, attrs=None):
            if out_name is None:
                out_name = unique_name(base + ".g_init.tmp")
                sb.create_var(name=out_name, dtype=dtype, stop_gradient=True)
            sb.append_op(op_type, ins, {"Out": [out_name]}, attrs or {})
            return out_name

        sq0 = sop("square", {"X": [v.name]})
        ss0 = sop("reduce_sum", {"X": [sq0]}, attrs=reduce_attrs)
        sop("sqrt", {"X": [ss0]}, out_name=g.name)

        def op(op_type, ins, attrs=None):
            out = self.create_variable_for_type_inference(dtype)
            self.append_op(op_type, ins, {"Out": [out.name]}, attrs or {})
            return out

        sq = op("square", {"X": [v.name]})
        ssum = op("reduce_sum", {"X": [sq.name]}, reduce_attrs)
        norm = op("sqrt", {"X": [ssum.name]})
        unit = op("elementwise_div", {"X": [v.name], "Y": [norm.name]})
        return op("elementwise_mul", {"X": [unit.name], "Y": [g.name]})

    def create_global_state_var(self, prefix, shape, dtype="float32",
                                fill_value=0) -> Variable:
        """Persistable non-trainable accumulator (metric stat buffers,
        reference metrics/auc_op.h persistable StatPos): lives in the main
        program's global block, zero-seeded by the startup program, and
        updated in place by ops that name it as both input and output."""
        name = unique_name(prefix)
        v = self.main_program.global_block.create_var(
            name=name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=True)
        sb = self.startup_program.global_block
        sb.create_var(name=name, shape=shape, dtype=dtype, persistable=True,
                      stop_gradient=True)
        sb.append_op("fill_constant", {}, {"Out": [name]},
                     {"shape": list(shape), "dtype": dtype,
                      "value": fill_value})
        return v

    def create_variable_for_type_inference(self, dtype="float32",
                                           stop_gradient=False) -> Variable:
        return self.block.create_var(name=unique_name(self.name + ".tmp"),
                                     dtype=dtype, stop_gradient=stop_gradient)

    def append_op(self, *args, **kw):
        return self.block.append_op(*args, **kw)

    def append_activation(self, out: Variable, act: Optional[str]):
        if act is None:
            return out
        v = self.create_variable_for_type_inference(out.dtype)
        self.block.append_op(act, {"X": [out.name]}, {"Out": [v.name]})
        return v

    def append_bias_op(self, out: Variable, bias, dim_start=1):
        if bias is None:
            return out
        v = self.create_variable_for_type_inference(out.dtype)
        self.block.append_op("elementwise_add",
                             {"X": [out.name], "Y": [bias.name]},
                             {"Out": [v.name]}, {"axis": dim_start})
        return v
