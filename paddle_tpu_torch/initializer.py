"""Parameter initializers: append init ops to the startup program.

Reference: python/paddle/fluid/initializer.py — Constant/Uniform/Normal/
Xavier/MSRA/NumpyArray initializers emitted as ops so `exe.run(startup)`
materializes all params on the executor's device. A copy of
`paddle_tpu/initializer.py`: it only appends ops.
"""

import math

import numpy as np

__all__ = ["Constant", "ConstantInitializer", "Uniform",
           "UniformInitializer", "Normal", "NormalInitializer",
           "TruncatedNormal", "TruncatedNormalInitializer", "Xavier",
           "XavierInitializer", "MSRA", "MSRAInitializer",
           "Bilinear", "BilinearInitializer", "NumpyArrayInitializer",
           "force_init_on_cpu", "init_on_cpu"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self._value = value

    def __call__(self, var, block):
        block.append_op("fill_constant", {}, {"Out": [var.name]},
                        {"shape": list(var.shape), "dtype": var.dtype,
                         "value": float(self._value)}, infer_shape=False)


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self._low = low
        self._high = high
        self._seed = seed

    def __call__(self, var, block):
        block.append_op("uniform_random", {}, {"Out": [var.name]},
                        {"shape": list(var.shape), "dtype": var.dtype,
                         "min": self._low, "max": self._high,
                         "seed": self._seed}, infer_shape=False)


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean = loc
        self._std = scale
        self._seed = seed

    def __call__(self, var, block):
        block.append_op("gaussian_random", {}, {"Out": [var.name]},
                        {"shape": list(var.shape), "dtype": var.dtype,
                         "mean": self._mean, "std": self._std,
                         "seed": self._seed}, infer_shape=False)


class TruncatedNormalInitializer(NormalInitializer):
    def __call__(self, var, block):
        block.append_op("truncated_gaussian_random", {}, {"Out": [var.name]},
                        {"shape": list(var.shape), "dtype": var.dtype,
                         "mean": self._mean, "std": self._std,
                         "seed": self._seed}, infer_shape=False)


def _fan_in_out(var):
    shape = var.shape
    if len(shape) < 2:
        return shape[0], shape[0]
    # conv filters: OIHW -> receptive field multiplies in/out channels
    receptive = 1
    for d in shape[2:]:
        receptive *= d
    fan_in = shape[1] * receptive
    fan_out = shape[0] * receptive
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    return fan_in, fan_out


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self._uniform = uniform
        self._fan_in = fan_in
        self._fan_out = fan_out
        self._seed = seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        if self._uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self._seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self._seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self._uniform = uniform
        self._fan_in = fan_in
        self._seed = seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self._fan_in if self._fan_in is not None else fi
        if self._uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self._seed)(var, block)
        else:
            std = math.sqrt(2.0 / fi)
            NormalInitializer(0.0, std, self._seed)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self._value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op("assign_value", {}, {"Out": [var.name]},
                        {"shape": list(self._value.shape),
                         "dtype": str(self._value.dtype),
                         "values": self._value.reshape(-1).tolist()},
                        infer_shape=False)


class BilinearInitializer(Initializer):
    """Bilinear-upsample kernel init for conv_transpose weights
    (reference: initializer.py BilinearInitializer): weight [c_in, c_out,
    kh, kw] gets the separable triangle kernel so the deconv starts as
    bilinear interpolation."""

    def __call__(self, var, block):
        shape = list(var.shape)
        if len(shape) != 4:
            raise ValueError("BilinearInitializer expects a 4-D weight")
        kh, kw = shape[2], shape[3]
        import numpy as _np
        fh, fw = (kh + 1) // 2, (kw + 1) // 2
        # separable triangle: w[i, j] = (1-|i/f - c|) * (1-|j/f - c|)
        cy = (2 * fh - 1 - fh % 2) / (2.0 * fh)
        cx = (2 * fw - 1 - fw % 2) / (2.0 * fw)
        ii = _np.arange(kh).reshape(-1, 1)
        jj = _np.arange(kw).reshape(1, -1)
        kern = ((1 - _np.abs(ii / fh - cy)) *
                (1 - _np.abs(jj / fw - cx))).astype("float32")
        weight = _np.zeros(shape, "float32")
        weight[:, :] = kern
        NumpyArrayInitializer(weight)(var, block)


def force_init_on_cpu():
    """reference: initializer.py force_init_on_cpu — parameters are made
    where the startup program runs (the executor's place); always False."""
    return False


from contextlib import contextmanager as _ctxmgr


@_ctxmgr
def init_on_cpu():
    """reference: initializer.py init_on_cpu — a no-op scope here
    (initialization runs where the startup program runs)."""
    yield


Bilinear = BilinearInitializer
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
