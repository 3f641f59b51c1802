"""Weight-decay regularizers appended to gradients as IR ops.

A copy of `paddle_tpu/regularizer.py` (which imports no JAX; reference:
python/paddle/fluid/regularizer.py): L1/L2 decay appended to each
param's grad before the update op, as `scale`, `sign` and `sum` ops. A
sparse (SelectedRows) grad is skipped with a warning, as in the
reference: decaying the untouched rows would densify it.
"""

from .framework.core import unique_name

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class _Regularizer:
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff


class L2DecayRegularizer(_Regularizer):
    def append(self, param, grad, block):
        decayed = block.create_var(name=unique_name(param.name + "@L2DECAY"),
                                   shape=param.shape, dtype=grad.dtype)
        block.append_op("scale", {"X": [param.name]},
                        {"Out": [decayed.name]},
                        {"scale": self._coeff}, infer_shape=False)
        out = block.create_var(name=unique_name(grad.name + "@REG"),
                               shape=param.shape, dtype=grad.dtype)
        block.append_op("sum", {"X": [grad.name, decayed.name]},
                        {"Out": [out.name]}, infer_shape=False)
        return out


class L1DecayRegularizer(_Regularizer):
    def append(self, param, grad, block):
        signv = block.create_var(name=unique_name(param.name + "@SIGN"),
                                 shape=param.shape, dtype=grad.dtype)
        block.append_op("sign", {"X": [param.name]}, {"Out": [signv.name]},
                        infer_shape=False)
        decayed = block.create_var(name=unique_name(param.name + "@L1DECAY"),
                                   shape=param.shape, dtype=grad.dtype)
        block.append_op("scale", {"X": [signv.name]}, {"Out": [decayed.name]},
                        {"scale": self._coeff}, infer_shape=False)
        out = block.create_var(name=unique_name(grad.name + "@REG"),
                               shape=param.shape, dtype=grad.dtype)
        block.append_op("sum", {"X": [grad.name, decayed.name]},
                        {"Out": [out.name]}, infer_shape=False)
        return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, global_regularizer=None):
    import warnings
    out = []
    for p, g in params_grads:
        reg = p.regularizer or global_regularizer
        if reg is None:
            out.append((p, g))
        elif g.type == "selected_rows":
            # decay of untouched rows would densify the sparse grad
            # (reference regularizer.py warns and skips likewise)
            warnings.warn(
                f"regularizer skipped for sparse gradient of {p.name!r}")
            out.append((p, g))
        else:
            out.append((p, reg.append(p, g, g.block)))
    return out
