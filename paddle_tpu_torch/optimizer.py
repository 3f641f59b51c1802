"""Optimizers: build update ops onto the program IR.

Port of `paddle_tpu/optimizer.py` (Optimizer :35, SGDOptimizer :238,
MomentumOptimizer :246, _AdamLike/AdamOptimizer :285-330; reference:
python/paddle/fluid/optimizer.py). The learning rate is a graph variable;
accumulators are persistable vars initialized in the startup program; the
update ops of `ops/optimizer_ops.py` run in the same Executor.run as the
backward pass.

`grad_clip=` takes the clips of `clip.py`, applied to the raw gradients
before the update ops. While a `train_stats.StepLogger` is installed,
`minimize` attaches the training telemetry tap (the global grad norm, the
finiteness flag and, for skip_step/halt, the gates); with none installed
the program is exactly what it was without the tap.

Not ported yet: the dygraph branch of `minimize` (ROADMAP A.12),
regularization and per-parameter regularizers (A.5, passing either raises)
and the other optimizers (LarsMomentum, AdamW, Lamb, ...: A.5).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from .framework.core import (Parameter, Program, Variable,
                             default_main_program,
                             default_startup_program, unique_name)
from .framework.backward import append_backward

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adam", "AdamOptimizer", "Lamb",
           "LambOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, grad_clip=None,
                 name: Optional[str] = None):
        if regularization is not None:
            raise NotImplementedError(
                "regularization is not ported to paddle_tpu_torch yet "
                "(ROADMAP A.5)")
        self._learning_rate = learning_rate
        self.grad_clip = grad_clip
        self._name = name or type(self).__name__.lower()
        self._accumulators: Dict[str, Dict[str, Variable]] = {}

    # -- learning rate var ---------------------------------------------------
    def _global_lr(self, program: Program, startup: Program) -> Variable:
        if isinstance(self._learning_rate, Variable):
            return self._learning_rate
        blk = program.global_block
        name = unique_name(f"{self._name}/learning_rate")
        lr = blk.create_var(name=name, shape=(1,), dtype="float32",
                            persistable=True, stop_gradient=True)
        sb = startup.global_block
        sb.create_var(name=name, shape=(1,), dtype="float32",
                      persistable=True, stop_gradient=True)
        sb.append_op("fill_constant", {}, {"Out": [name]},
                     {"shape": [1], "dtype": "float32",
                      "value": float(self._learning_rate)},
                     infer_shape=False)
        self._learning_rate = lr
        return lr

    # -- accumulators --------------------------------------------------------
    def _add_accumulator(self, name: str, param: Parameter, startup: Program,
                         fill_value: float = 0.0, shape=None,
                         dtype: str = "float32") -> Variable:
        shape = tuple(shape) if shape is not None else tuple(param.shape)
        vname = unique_name(f"{self._name}/{param.name}/{name}")
        blk = param.block
        acc = blk.create_var(name=vname, shape=shape, dtype=dtype,
                             persistable=True, stop_gradient=True)
        sb = startup.global_block
        sb.create_var(name=vname, shape=shape, dtype=dtype, persistable=True,
                      stop_gradient=True)
        sb.append_op("fill_constant", {}, {"Out": [vname]},
                     {"shape": list(shape), "dtype": dtype,
                      "value": float(fill_value)}, infer_shape=False)
        self._accumulators.setdefault(name, {})[param.name] = acc
        return acc

    # -- per-optimizer hooks -------------------------------------------------
    def _create_accumulators(self, param: Parameter, startup: Program):
        pass

    def _append_optimize_op(self, block, param, grad, lr) -> None:
        raise NotImplementedError

    # -- main entry ----------------------------------------------------------
    def minimize(self, loss: Variable,
                 startup_program: Optional[Program] = None,
                 parameter_list: Optional[Sequence[str]] = None,
                 no_grad_set=None):
        params_grads = self.backward(loss, parameter_list=parameter_list,
                                     no_grad_set=no_grad_set)
        opt_ops = self.apply_gradients(
            params_grads, loss.block.program,
            startup_program or default_startup_program())
        # Training telemetry tap (observability/train_stats.py): while a
        # StepLogger is installed, attach the global grad-norm var (the
        # one GradientClipByGlobalNorm already computed, or a fresh
        # reduction) and the in-graph numerics-sentinel flag. Without a
        # logger the program stays byte-identical — zero extra ops.
        from .observability import train_stats
        logger = train_stats.get_step_logger()
        if logger is not None:
            train_stats.attach_step_telemetry(
                loss.block.program, loss, params_grads, self,
                policy=logger.policy)
        return opt_ops, params_grads

    def backward(self, loss, parameter_list=None, no_grad_set=None,
                 callbacks=None):
        return append_backward(loss, parameter_list=parameter_list,
                               no_grad_set=no_grad_set)

    def apply_gradients(self, params_grads, program=None, startup=None):
        program = program or default_main_program()
        startup = startup or default_startup_program()
        block = program.global_block
        n_before = len(block.ops)
        if any(p.regularizer is not None for p, _ in params_grads):
            raise NotImplementedError(
                "per-parameter regularizers are not ported to "
                "paddle_tpu_torch yet (ROADMAP A.5)")
        # clip raw gradients first (reference optimizer.py:526-529 order;
        # weight decay, which follows there, is A.5)
        if self.grad_clip is not None:
            params_grads = self.grad_clip(params_grads)
        lr = self._global_lr(program, startup)
        ops = []
        for p, g in params_grads:
            self._create_accumulators(p, startup)
            ops.append(self._append_optimize_op(
                block, p, g, self._param_lr(block, lr, p)))
        # tag everything appended here so clone(for_test=True) prunes it
        for op in block.ops[n_before:]:
            op.attrs.setdefault("op_role", "optimize")
        return ops

    def _param_lr(self, block, lr: Variable, param) -> Variable:
        """Per-parameter LR multiplier (ParamAttr.learning_rate; reference:
        optimizer.py _create_param_lr)."""
        mult = getattr(param, "optimize_attrs", {}).get("learning_rate", 1.0)
        if mult == 1.0:
            return lr
        v = block.create_var(name=unique_name(f"{param.name}/lr"),
                             shape=(1,), dtype="float32", stop_gradient=True)
        block.append_op("scale", {"X": [lr.name]}, {"Out": [v.name]},
                        {"scale": float(mult)})
        return v


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, p, g, lr):
        return block.append_op(
            "sgd",
            {"Param": [p.name], "Grad": [g.name], "LearningRate": [lr.name]},
            {"ParamOut": [p.name]}, infer_shape=False)


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, p, startup):
        self._add_accumulator("velocity", p, startup)

    def _append_optimize_op(self, block, p, g, lr):
        v = self._accumulators["velocity"][p.name]
        return block.append_op(
            "momentum",
            {"Param": [p.name], "Grad": [g.name], "Velocity": [v.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [p.name], "VelocityOut": [v.name]},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov},
            infer_shape=False)


class _AdamLike(Optimizer):
    op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, p, startup):
        self._add_accumulator("moment1", p, startup)
        self._add_accumulator("moment2", p, startup)
        self._add_accumulator("beta1_pow", p, startup, shape=(1,),
                              fill_value=self._beta1)
        self._add_accumulator("beta2_pow", p, startup, shape=(1,),
                              fill_value=self._beta2)

    def _append_optimize_op(self, block, p, g, lr):
        a = self._accumulators
        return block.append_op(
            self.op_type,
            {"Param": [p.name], "Grad": [g.name], "LearningRate": [lr.name],
             "Moment1": [a["moment1"][p.name].name],
             "Moment2": [a["moment2"][p.name].name],
             "Beta1Pow": [a["beta1_pow"][p.name].name],
             "Beta2Pow": [a["beta2_pow"][p.name].name]},
            {"ParamOut": [p.name],
             "Moment1Out": [a["moment1"][p.name].name],
             "Moment2Out": [a["moment2"][p.name].name],
             "Beta1PowOut": [a["beta1_pow"][p.name].name],
             "Beta2PowOut": [a["beta2_pow"][p.name].name]},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon}, infer_shape=False)


class AdamOptimizer(_AdamLike):
    op_type = "adam"


class LambOptimizer(Optimizer):
    def __init__(self, *args, **kw):
        raise NotImplementedError(
            "Lamb is not ported to paddle_tpu_torch yet; it comes with the "
            "optimizer slice (ROADMAP.md queue A.5)")


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Lamb = LambOptimizer
