"""Tensor layers of the inference slice: data, reshape, slice, arange.

Copied from `paddle_tpu/layers/tensor.py`: the same op types, slots and
attrs, so a program built by either DSL serializes alike.
"""

import numpy as np

from ..framework.core import convert_np_dtype, default_main_program
from ..framework.layer_helper import LayerHelper

__all__ = ["data", "reshape", "slice", "arange"]


def data(name, shape, dtype="float32", append_batch_size=True,
         stop_gradient=True):
    """Declare a feed variable (reference: layers/io.py data)."""
    shape = list(shape)
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + shape
    blk = default_main_program().global_block
    return blk.create_var(name=name, shape=shape,
                          dtype=convert_np_dtype(dtype),
                          stop_gradient=stop_gradient, is_data=True)


def reshape(x, shape, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("reshape2", {"X": [x.name]},
                     {"Out": [out.name], "XShape": [xshape.name]},
                     {"shape": list(shape)})
    return out


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("slice", {"Input": [input.name]}, {"Out": [out.name]},
                     {"axes": list(axes), "starts": list(starts),
                      "ends": list(ends)})
    return out


def arange(start, end, step=1, dtype="float32", name=None):
    vals = np.arange(start, end, step).astype(dtype)
    helper = LayerHelper("arange", name=name)
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("assign_value", {}, {"Out": [out.name]},
                     {"shape": list(vals.shape), "dtype": dtype,
                      "values": vals.reshape(-1).tolist()})
    return out
