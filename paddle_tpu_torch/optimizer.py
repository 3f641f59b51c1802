"""Optimizers: build update ops onto the program IR.

Port of `paddle_tpu/optimizer.py` (reference: python/paddle/fluid/
optimizer.py): the Optimizer base (:35) with its regularization and
`_finish_update` hooks, and every optimizer of the JAX file (SGD,
Momentum, LarsMomentum, Adam, AdamW, Lamb, Adagrad, ProximalGD,
ProximalAdagrad, DecayedAdagrad, Adadelta, Adamax, RMSProp, Ftrl,
DGCMomentum on one rank), ExponentialMovingAverage and ModelAverage. The
learning rate is a graph variable (an LR schedule of
layers/learning_rate_scheduler.py is itself ops); accumulators are
persistable vars initialized in the startup program; the update ops of
`ops/optimizer_ops.py` run in the same Executor.run as the backward pass.

`apply_gradients` clips the raw gradients first (`grad_clip=`, the clips
of `clip.py`), then adds weight decay (`regularization=`, or a
parameter's own regularizer, `regularizer.py`), in the reference's order
(optimizer.py:526-529). While a `train_stats.StepLogger` is installed,
`minimize` attaches the training telemetry tap (the global grad norm, the
finiteness flag and, for skip_step/halt, the gates); with none installed
the program is exactly what it was without the tap.

`GradientMergeOptimizer` runs the inner update in a `layers.cond` true
branch every k-th step (a conditional_block; its sub-block's update ops
run without donation). Still raising, each naming its ROADMAP item:
`DGCMomentumOptimizer` with nranks > 1 (its c_allreduce_sum: the
parallelism slice, A.8) and `PipelineOptimizer` (A.8). The dygraph branch
of `minimize` is A.12.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

from .framework.core import (Parameter, Program, Variable,
                             default_main_program,
                             default_startup_program, unique_name)
from .framework.backward import append_backward

__all__ = [
    "Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
    "Adam", "AdamOptimizer", "AdamW", "AdamWOptimizer", "Adagrad",
    "AdagradOptimizer", "DecayedAdagrad", "DecayedAdagradOptimizer",
    "Adadelta", "AdadeltaOptimizer", "Adamax", "AdamaxOptimizer", "RMSProp",
    "RMSPropOptimizer", "Ftrl", "FtrlOptimizer", "Lamb", "LambOptimizer",
    "LarsMomentum", "LarsMomentumOptimizer", "ProximalGD",
    "ProximalGDOptimizer", "ProximalAdagrad", "ProximalAdagradOptimizer",
    "ExponentialMovingAverage",
    "ModelAverage", "PipelineOptimizer", "DGCMomentumOptimizer",
    "GradientMergeOptimizer",
]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, grad_clip=None,
                 name: Optional[str] = None):
        self._learning_rate = learning_rate
        self.regularization = regularization
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

    # -- regularization / clip ----------------------------------------------
    def _apply_regularization(self, params_grads):
        from .regularizer import append_regularization_ops
        return append_regularization_ops(params_grads, self.regularization)

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
        # clip raw gradients first, then add weight decay
        # (reference optimizer.py:526-529 order)
        if self.grad_clip is not None:
            params_grads = self.grad_clip(params_grads)
        params_grads = self._apply_regularization(params_grads)
        lr = self._global_lr(program, startup)
        ops = []
        for p, g in params_grads:
            self._create_accumulators(p, startup)
            ops.append(self._append_optimize_op(
                block, p, g, self._param_lr(block, lr, p)))
        self._finish_update(block, params_grads, startup)
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

    def _finish_update(self, block, params_grads, startup):
        pass


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


class LarsMomentumOptimizer(MomentumOptimizer):
    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, momentum, **kw)
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _append_optimize_op(self, block, p, g, lr):
        v = self._accumulators["velocity"][p.name]
        return block.append_op(
            "lars_momentum",
            {"Param": [p.name], "Grad": [g.name], "Velocity": [v.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [p.name], "VelocityOut": [v.name]},
            {"mu": self._momentum, "lars_coeff": self._lars_coeff,
             "lars_weight_decay": self._lars_weight_decay},
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

    def _extra_attrs(self):
        return {}

    def _append_optimize_op(self, block, p, g, lr):
        a = self._accumulators
        attrs = {"beta1": self._beta1, "beta2": self._beta2,
                 "epsilon": self._epsilon}
        attrs.update(self._extra_attrs())
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
            attrs, infer_shape=False)


class AdamOptimizer(_AdamLike):
    op_type = "adam"


class AdamWOptimizer(_AdamLike):
    op_type = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, coeff=0.01, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._coeff = coeff

    def _extra_attrs(self):
        return {"coeff": self._coeff, "with_decay": True}


class LambOptimizer(_AdamLike):
    op_type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._weight_decay = lamb_weight_decay

    def _extra_attrs(self):
        return {"weight_decay": self._weight_decay}


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, p, startup):
        self._add_accumulator("moment", p, startup)

    def _append_optimize_op(self, block, p, g, lr):
        m = self._accumulators["moment"][p.name]
        return block.append_op(
            "adagrad",
            {"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [p.name], "MomentOut": [m.name]},
            {"epsilon": self._epsilon}, infer_shape=False)


class ProximalGDOptimizer(Optimizer):
    """reference: optimizer.py ProximalGDOptimizer (optimizers/
    proximal_gd_op.cc) — GD step followed by the l1/l2 proximal operator."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1 = l1
        self._l2 = l2

    def _append_optimize_op(self, block, p, g, lr):
        return block.append_op(
            "proximal_gd",
            {"Param": [p.name], "Grad": [g.name], "LearningRate": [lr.name]},
            {"ParamOut": [p.name]},
            {"l1": self._l1, "l2": self._l2}, infer_shape=False)


class ProximalAdagradOptimizer(Optimizer):
    """reference: optimizer.py ProximalAdagradOptimizer (optimizers/
    proximal_adagrad_op.cc)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1 = l1
        self._l2 = l2

    def _create_accumulators(self, p, startup):
        self._add_accumulator("moment", p, startup)

    def _append_optimize_op(self, block, p, g, lr):
        m = self._accumulators["moment"][p.name]
        return block.append_op(
            "proximal_adagrad",
            {"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [p.name], "MomentOut": [m.name]},
            {"l1": self._l1, "l2": self._l2}, infer_shape=False)


class DecayedAdagradOptimizer(AdagradOptimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, epsilon, **kw)
        self._decay = decay

    def _append_optimize_op(self, block, p, g, lr):
        m = self._accumulators["moment"][p.name]
        return block.append_op(
            "decayed_adagrad",
            {"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [p.name], "MomentOut": [m.name]},
            {"decay": self._decay, "epsilon": self._epsilon},
            infer_shape=False)


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, p, startup):
        self._add_accumulator("avg_squared_grad", p, startup)
        self._add_accumulator("avg_squared_update", p, startup)

    def _append_optimize_op(self, block, p, g, lr):
        a = self._accumulators
        return block.append_op(
            "adadelta",
            {"Param": [p.name], "Grad": [g.name],
             "AvgSquaredGrad": [a["avg_squared_grad"][p.name].name],
             "AvgSquaredUpdate": [a["avg_squared_update"][p.name].name],
             "LearningRate": [lr.name]},
            {"ParamOut": [p.name],
             "AvgSquaredGradOut": [a["avg_squared_grad"][p.name].name],
             "AvgSquaredUpdateOut": [a["avg_squared_update"][p.name].name]},
            {"rho": self._rho, "epsilon": self._epsilon}, infer_shape=False)


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, p, startup):
        self._add_accumulator("moment", p, startup)
        self._add_accumulator("inf_norm", p, startup)
        self._add_accumulator("beta1_pow", p, startup, shape=(1,),
                              fill_value=self._beta1)

    def _append_optimize_op(self, block, p, g, lr):
        a = self._accumulators
        return block.append_op(
            "adamax",
            {"Param": [p.name], "Grad": [g.name], "LearningRate": [lr.name],
             "Moment": [a["moment"][p.name].name],
             "InfNorm": [a["inf_norm"][p.name].name],
             "Beta1Pow": [a["beta1_pow"][p.name].name]},
            {"ParamOut": [p.name], "MomentOut": [a["moment"][p.name].name],
             "InfNormOut": [a["inf_norm"][p.name].name]},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon}, infer_shape=False)

    def _finish_update(self, block, params_grads, startup):
        # beta1_pow update: scale in-graph
        for p, g in params_grads:
            b1p = self._accumulators["beta1_pow"][p.name]
            block.append_op("scale", {"X": [b1p.name]}, {"Out": [b1p.name]},
                            {"scale": self._beta1}, infer_shape=False)


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self, p, startup):
        self._add_accumulator("mean_square", p, startup)
        self._add_accumulator("moment", p, startup)
        if self._centered:
            self._add_accumulator("mean_grad", p, startup)

    def _append_optimize_op(self, block, p, g, lr):
        a = self._accumulators
        ins = {"Param": [p.name], "Grad": [g.name],
               "MeanSquare": [a["mean_square"][p.name].name],
               "Moment": [a["moment"][p.name].name],
               "LearningRate": [lr.name]}
        outs = {"ParamOut": [p.name],
                "MeanSquareOut": [a["mean_square"][p.name].name],
                "MomentOut": [a["moment"][p.name].name]}
        if self._centered:
            ins["MeanGrad"] = [a["mean_grad"][p.name].name]
            outs["MeanGradOut"] = [a["mean_grad"][p.name].name]
        return block.append_op(
            "rmsprop", ins, outs,
            {"decay": self._rho, "epsilon": self._epsilon,
             "momentum": self._momentum, "centered": self._centered},
            infer_shape=False)


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, p, startup):
        self._add_accumulator("squared", p, startup)
        self._add_accumulator("linear", p, startup)

    def _append_optimize_op(self, block, p, g, lr):
        a = self._accumulators
        return block.append_op(
            "ftrl",
            {"Param": [p.name], "Grad": [g.name],
             "SquaredAccumulator": [a["squared"][p.name].name],
             "LinearAccumulator": [a["linear"][p.name].name],
             "LearningRate": [lr.name]},
            {"ParamOut": [p.name],
             "SquaredAccumOut": [a["squared"][p.name].name],
             "LinearAccumOut": [a["linear"][p.name].name]},
            {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
            infer_shape=False)


class ExponentialMovingAverage:
    """EMA of trainable params (reference: optimizer.py:2435). update()
    appends the shadow update to the training program (it runs in the same
    Executor.run as the step); apply()/restore() swap the global scope's
    values (use `scope_guard` for another scope)."""

    def __init__(self, decay=0.999, name=None):
        self._decay = decay
        self._name = name or "ema"
        self._shadows = {}  # param name -> shadow var name
        self._backup = {}

    def update(self, program: Optional[Program] = None,
               startup: Optional[Program] = None):
        program = program or default_main_program()
        startup = startup or default_startup_program()
        blk = program.global_block
        for p in program.all_parameters():
            if not p.trainable:
                continue
            sname = unique_name(f"{self._name}/{p.name}")
            blk.create_var(name=sname, shape=p.shape, dtype=p.dtype,
                           persistable=True, stop_gradient=True)
            sb = startup.global_block
            sb.create_var(name=sname, shape=p.shape, dtype=p.dtype,
                          persistable=True, stop_gradient=True)
            # shadow starts at the initial param value
            sb.append_op("assign", {"X": [p.name]}, {"Out": [sname]},
                         infer_shape=False)
            # shadow = decay*shadow + (1-decay)*param
            scaled_s = unique_name(f"{self._name}/tmp")
            blk.create_var(name=scaled_s, shape=p.shape, dtype=p.dtype)
            blk.append_op("scale", {"X": [sname]}, {"Out": [scaled_s]},
                          {"scale": self._decay, "op_role": "optimize"},
                          infer_shape=False)
            scaled_p = unique_name(f"{self._name}/tmp")
            blk.create_var(name=scaled_p, shape=p.shape, dtype=p.dtype)
            blk.append_op("scale", {"X": [p.name]}, {"Out": [scaled_p]},
                          {"scale": 1.0 - self._decay,
                           "op_role": "optimize"}, infer_shape=False)
            blk.append_op("sum", {"X": [scaled_s, scaled_p]},
                          {"Out": [sname]}, {"op_role": "optimize"},
                          infer_shape=False)
            self._shadows[p.name] = sname

    def apply(self, executor=None, need_restore=True):
        from .framework.executor import global_scope

        @contextlib.contextmanager
        def _ctx():
            scope = global_scope()
            self._backup = {p: scope.find_var(p) for p in self._shadows}
            for p, s in self._shadows.items():
                sv = scope.find_var(s)
                if sv is not None:
                    scope.set_var(p, sv)
            try:
                yield
            finally:
                if need_restore:
                    self.restore()

        return _ctx()

    def restore(self, executor=None):
        from .framework.executor import global_scope
        scope = global_scope()
        for p, v in self._backup.items():
            scope.set_var(p, v)
        self._backup = {}


class ModelAverage:
    """Windowed parameter average (reference: optimizer.py:2245). The
    accumulation restarts whenever the window exceeds max_average_window
    (the reference's restart semantics, without its 3-tier sum cascade):
    sum/cnt reset to the current param once cnt reaches the cap, so apply()
    averages at most the last max_average_window steps."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, name=None):
        self._name = name or "model_average"
        self._max_window = float(max_average_window)
        self._sums = {}
        self._cnt_name = None
        self._backup = {}

    def _build(self, program, startup):
        blk = program.global_block
        sb = startup.global_block

        def _pvar(name, shape, fill):
            blk.create_var(name=name, shape=shape, dtype="float32",
                           persistable=True, stop_gradient=True)
            sb.create_var(name=name, shape=shape, dtype="float32",
                          persistable=True, stop_gradient=True)
            sb.append_op("fill_constant", {}, {"Out": [name]},
                         {"shape": list(shape), "dtype": "float32",
                          "value": fill}, infer_shape=False)

        self._cnt_name = unique_name(f"{self._name}/cnt")
        _pvar(self._cnt_name, (1,), 0.0)
        # restart flag: cnt >= max_window
        cap = unique_name(f"{self._name}/cap")
        blk.create_var(name=cap, shape=(1,), dtype="float32",
                       stop_gradient=True)
        blk.append_op("fill_constant", {}, {"Out": [cap]},
                      {"shape": [1], "dtype": "float32",
                       "value": self._max_window, "op_role": "optimize"},
                      infer_shape=False)
        restart = unique_name(f"{self._name}/restart")
        blk.create_var(name=restart, shape=(1,), dtype="bool",
                       stop_gradient=True)
        blk.append_op("greater_equal",
                      {"X": [self._cnt_name], "Y": [cap]},
                      {"Out": [restart]}, {"op_role": "optimize"},
                      infer_shape=False)
        one = unique_name(f"{self._name}/one")
        blk.create_var(name=one, shape=(1,), dtype="float32",
                       stop_gradient=True)
        blk.append_op("fill_constant", {}, {"Out": [one]},
                      {"shape": [1], "dtype": "float32", "value": 1.0,
                       "op_role": "optimize"}, infer_shape=False)
        nxt = unique_name(f"{self._name}/next_cnt")
        blk.create_var(name=nxt, shape=(1,), dtype="float32",
                       stop_gradient=True)
        blk.append_op("sum", {"X": [self._cnt_name, one]}, {"Out": [nxt]},
                      {"op_role": "optimize"}, infer_shape=False)
        blk.append_op("where",
                      {"Condition": [restart], "X": [one], "Y": [nxt]},
                      {"Out": [self._cnt_name]}, {"op_role": "optimize"},
                      infer_shape=False)
        for p in program.all_parameters():
            if not p.trainable:
                continue
            sname = unique_name(f"{self._name}/{p.name}/sum")
            _pvar(sname, tuple(p.shape), 0.0)
            acc = unique_name(f"{self._name}/acc")
            blk.create_var(name=acc, shape=p.shape, dtype="float32",
                           stop_gradient=True)
            blk.append_op("sum", {"X": [sname, p.name]}, {"Out": [acc]},
                          {"op_role": "optimize"}, infer_shape=False)
            # on restart the window begins again at the current param
            blk.append_op("where",
                          {"Condition": [restart], "X": [p.name],
                           "Y": [acc]},
                          {"Out": [sname]}, {"op_role": "optimize"},
                          infer_shape=False)
            self._sums[p.name] = sname

    def update(self, program=None, startup=None):
        self._build(program or default_main_program(),
                    startup or default_startup_program())

    def apply(self, executor=None, need_restore=True):
        from .framework.executor import global_scope

        @contextlib.contextmanager
        def _ctx():
            scope = global_scope()
            cnt = float(scope.find_var(self._cnt_name).reshape(-1)[0])
            self._backup = {p: scope.find_var(p) for p in self._sums}
            for p, s in self._sums.items():
                sv = scope.find_var(s)
                pv = self._backup[p]
                scope.set_var(p, (sv / max(cnt, 1.0)).to(pv.dtype))
            try:
                yield
            finally:
                if need_restore:
                    self.restore()

        return _ctx()

    def restore(self, executor=None):
        from .framework.executor import global_scope
        scope = global_scope()
        for p, v in self._backup.items():
            scope.set_var(p, v)
        self._backup = {}


class DGCMomentumOptimizer(Optimizer):
    """Deep Gradient Compression momentum (reference: optimizer.py:787
    DGCMomentumOptimizer + details/sparse_all_reduce_op_handle.cc).

    Per step and per parameter: momentum correction (U = mu*U + g), error
    feedback (V += U), top-(1-sparsity) selection of |V|, and an UPDATE
    using only the selected values; the unsent remainder stays in V. The
    selected values travel as a SelectedRows over the flattened gradient;
    on one rank dgc_gather densifies them for the SGD step. With nranks > 1
    the JAX package allreduces them (a sparse allgather, the DGC
    communication saving); that is the parallelism slice (ROADMAP A.8).

    Note the degenerate case: with sparsity 0 every element is selected
    and momentum-factor masking clears U each step, so the trajectory
    equals plain SGD — momentum only matters for the unsent residual, as
    in the paper. rampup_begin_step is accepted for API parity (the
    reference ramps sparsity up over early steps; here sparsity is fixed
    per program build — rebuild with a different sparsity to ramp).
    """

    def __init__(self, learning_rate, momentum, sparsity=0.999,
                 rampup_begin_step=0, nranks=1, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        if isinstance(sparsity, (list, tuple)):
            sparsity = sparsity[-1]
        self._sparsity = float(sparsity)
        self._rampup = int(rampup_begin_step)
        self._nranks = int(nranks)
        if self._nranks > 1:
            raise NotImplementedError(
                "DGCMomentumOptimizer(nranks>1) needs c_allreduce_sum, "
                "which is not ported to paddle_tpu_torch yet (ROADMAP A.8: "
                "parallelism)")

    def _create_accumulators(self, p, startup):
        self._add_accumulator("dgc_u", p, startup)
        self._add_accumulator("dgc_v", p, startup)

    def _append_optimize_op(self, block, p, g, lr):
        u = self._accumulators["dgc_u"][p.name]
        v = self._accumulators["dgc_v"][p.name]
        numel = 1
        for d in p.shape:
            numel *= int(d)
        sparse = block.create_var(name=unique_name(f"{p.name}@DGC"),
                                  shape=(numel, 1), dtype="float32",
                                  type="selected_rows")
        block.append_op(
            "dgc", {"Grad": [g.name], "U": [u.name], "V": [v.name]},
            {"Out": [sparse.name], "UOut": [u.name], "VOut": [v.name]},
            {"momentum": self._momentum, "sparsity": self._sparsity},
            infer_shape=False)
        dense = block.create_var(name=unique_name(f"{p.name}@DGC_DENSE"),
                                 shape=p.shape, dtype="float32")
        block.append_op("dgc_gather", {"X": [sparse.name]},
                        {"Out": [dense.name]},
                        {"shape": list(p.shape)}, infer_shape=False)
        # momentum is already folded into U/V; the update itself is SGD
        return block.append_op(
            "sgd",
            {"Param": [p.name], "Grad": [dense.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [p.name]}, infer_shape=False)


class GradientMergeOptimizer:
    """Accumulate gradients over k micro-steps, apply the inner optimizer
    once per k (reference: the batch-merge pass ir/multi_batch_merge_pass.cc
    and test_dist_mnist_batch_merge.py). Built on cond: the k-th step runs
    the inner update ops in the true branch and resets the accumulators."""

    def __init__(self, inner_optimizer, k_steps: int = 1, avg: bool = True):
        self.inner = inner_optimizer
        self.k = int(k_steps)
        self.avg = avg

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from . import layers
        from .framework.core import default_startup_program
        startup = startup_program or default_startup_program()
        main = loss.block.program
        block = main.global_block
        params_grads = self.inner.backward(
            loss, parameter_list=parameter_list, no_grad_set=no_grad_set)
        n_before = len(block.ops)

        # step counter
        step_name = unique_name("grad_merge_step")
        block.create_var(name=step_name, shape=(1,), dtype="float32",
                         persistable=True, stop_gradient=True)
        sb = startup.global_block
        sb.create_var(name=step_name, shape=(1,), dtype="float32",
                      persistable=True, stop_gradient=True)
        sb.append_op("fill_constant", {}, {"Out": [step_name]},
                     {"shape": [1], "dtype": "float32", "value": 0.0},
                     infer_shape=False)
        block.append_op("increment", {"X": [step_name]},
                        {"Out": [step_name]}, {"step": 1.0},
                        infer_shape=False)
        step = block.var(step_name)

        # gradient accumulators
        accs = []
        for p, g in params_grads:
            acc_name = unique_name(f"{p.name}@GRAD_MERGE")
            block.create_var(name=acc_name, shape=p.shape, dtype=g.dtype,
                             persistable=True, stop_gradient=True)
            sb.create_var(name=acc_name, shape=p.shape, dtype=g.dtype,
                          persistable=True, stop_gradient=True)
            sb.append_op("fill_constant", {}, {"Out": [acc_name]},
                         {"shape": list(p.shape), "dtype": g.dtype,
                          "value": 0.0}, infer_shape=False)
            block.append_op("sum", {"X": [acc_name, g.name]},
                            {"Out": [acc_name]}, infer_shape=False)
            accs.append(block.var(acc_name))

        # inner optimizer state must exist OUTSIDE the cond branches
        lr = self.inner._global_lr(main, startup)
        for p, _ in params_grads:
            self.inner._create_accumulators(p, startup)
        state_vars = [v for by_param in self.inner._accumulators.values()
                      for v in by_param.values()]

        boundary = layers.equal(
            layers.elementwise_mod(
                step, layers.fill_constant([1], "float32", float(self.k))),
            layers.fill_constant([1], "float32", 0.0))

        ret_vars = [p for p, _ in params_grads] + state_vars + accs

        def true_fn():
            cur = main.current_block()
            effs = []
            for (p, _), acc in zip(params_grads, accs):
                eff = cur.create_var(
                    name=unique_name(f"{p.name}@GRAD_EFF"),
                    shape=p.shape, dtype=acc.dtype)
                cur.append_op("scale", {"X": [acc.name]},
                              {"Out": [eff.name]},
                              {"scale": 1.0 / self.k if self.avg else 1.0},
                              infer_shape=False)
                effs.append(cur.var(eff.name))
            # the inner optimizer's clip + weight decay act on the MERGED
            # gradient, same order as apply_gradients
            pgs = [(p, e) for (p, _), e in zip(params_grads, effs)]
            if self.inner.grad_clip is not None:
                pgs = self.inner.grad_clip(pgs)
            pgs = self.inner._apply_regularization(pgs)
            for (p, g), acc in zip(pgs, accs):
                self.inner._append_optimize_op(
                    cur, p, g, self.inner._param_lr(cur, lr, p))
                cur.append_op("scale", {"X": [acc.name]},
                              {"Out": [acc.name]}, {"scale": 0.0},
                              infer_shape=False)
            return list(ret_vars)

        def false_fn():
            return list(ret_vars)

        outs = layers.cond(boundary, true_fn, false_fn)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        for var, out in zip(ret_vars, outs):
            block.append_op("assign", {"X": [out.name]},
                            {"Out": [var.name]}, infer_shape=False)
        for op in block.ops[n_before:]:
            op.attrs.setdefault("op_role", "optimize")
        return [], params_grads


class PipelineOptimizer:
    """Pipeline-parallel wrapper (`paddle_tpu/parallel/pipeline.py`
    PipelineOptimizer): the parallelism slice (ROADMAP A.8)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PipelineOptimizer is not ported to paddle_tpu_torch yet "
            "(ROADMAP A.8: parallelism)")


# short aliases matching paddle 2.x style
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
Adamax = AdamaxOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
ProximalGD = ProximalGDOptimizer
ProximalAdagrad = ProximalAdagradOptimizer
