"""Tensor layers: data, fill_constant, fill_constant_batch_size_like,
cast, concat, split, reshape, squeeze, unsqueeze, transpose, slice,
assign, where, arange, argmax, increment, create_global_var,
create_parameter.

Copied from `paddle_tpu/layers/tensor.py`: the same op types, slots and
attrs, so a program built by either DSL serializes alike.
"""

import numpy as np

from ..framework.core import (Variable, convert_np_dtype,
                              default_main_program, unique_name)
from ..framework.layer_helper import LayerHelper

__all__ = ["data", "fill_constant", "fill_constant_batch_size_like", "cast",
           "concat", "split", "reshape", "squeeze", "unsqueeze",
           "transpose", "slice", "assign", "where", "arange", "argmax",
           "increment", "create_global_var", "create_parameter", "load"]

_builtin_range = range


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


def fill_constant(shape, dtype, value, name=None):
    helper = LayerHelper("fill_constant", name=name)
    out = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    helper.append_op("fill_constant", {}, {"Out": [out.name]},
                     {"shape": list(shape), "dtype": convert_np_dtype(dtype),
                      "value": float(value)})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  name=None):
    helper = LayerHelper("fill_constant_batch_size_like", name=name)
    out = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    helper.append_op("fill_constant_batch_size_like",
                     {"Input": [input.name]}, {"Out": [out.name]},
                     {"shape": list(shape), "dtype": convert_np_dtype(dtype),
                      "value": float(value), "input_dim_idx": input_dim_idx,
                      "output_dim_idx": output_dim_idx})
    return out


def cast(x, dtype, name=None):
    helper = LayerHelper("cast", name=name)
    dtype = convert_np_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", {"X": [x.name]}, {"Out": [out.name]},
                     {"out_dtype": dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", {"X": [v.name for v in input]},
                     {"Out": [out.name]}, {"axis": axis})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim % len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in _builtin_range(n)]
    helper.append_op("split", {"X": [input.name]},
                     {"Out": [o.name for o in outs]}, attrs)
    return outs


def reshape(x, shape, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("reshape2", {"X": [x.name]},
                     {"Out": [out.name], "XShape": [xshape.name]},
                     {"shape": list(shape)})
    return out


def squeeze(x, axes=None, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("squeeze2", {"X": [x.name]},
                     {"Out": [out.name], "XShape": [xshape.name]},
                     {"axes": axes or []})
    return out


def unsqueeze(x, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    axes = axes if isinstance(axes, (list, tuple)) else [axes]
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("unsqueeze2", {"X": [x.name]},
                     {"Out": [out.name], "XShape": [xshape.name]},
                     {"axes": list(axes)})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("transpose2", {"X": [x.name]},
                     {"Out": [out.name], "XShape": [xshape.name]},
                     {"axis": list(perm)})
    return out


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("slice", {"Input": [input.name]}, {"Out": [out.name]},
                     {"axes": list(axes), "starts": list(starts),
                      "ends": list(ends)})
    return out


def assign(input, output=None, name=None):
    helper = LayerHelper("assign", name=name)
    if output is None:
        output = helper.create_variable_for_type_inference(
            input.dtype if isinstance(input, Variable) else "float32")
    if isinstance(input, Variable):
        helper.append_op("assign", {"X": [input.name]},
                         {"Out": [output.name]})
    else:
        arr = np.asarray(input)
        helper.append_op("assign_value", {}, {"Out": [output.name]},
                         {"shape": list(arr.shape), "dtype": str(arr.dtype),
                          "values": arr.reshape(-1).tolist()})
    return output


def where(condition, x, y, name=None):
    helper = LayerHelper("where", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("where",
                     {"Condition": [condition.name], "X": [x.name],
                      "Y": [y.name]}, {"Out": [out.name]})
    return out


def arange(start, end, step=1, dtype="float32", name=None):
    vals = np.arange(start, end, step).astype(dtype)
    helper = LayerHelper("arange", name=name)
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("assign_value", {}, {"Out": [out.name]},
                     {"shape": list(vals.shape), "dtype": dtype,
                      "values": vals.reshape(-1).tolist()})
    return out


def argmax(x, axis=-1, dtype="int64", keepdims=False, name=None):
    helper = LayerHelper("arg_max", name=name)
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("arg_max", {"X": [x.name]}, {"Out": [out.name]},
                     {"axis": axis, "dtype": dtype, "keepdims": keepdims})
    return out


def increment(x, value=1.0, in_place=True, name=None):
    helper = LayerHelper("increment", name=name)
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", {"X": [x.name]}, {"Out": [out.name]},
                     {"step": float(value)}, infer_shape=False)
    return out


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """Creates a persistable var initialized in the startup program."""
    from ..framework.core import (default_main_program,
                                  default_startup_program)
    name = name or unique_name("global_var")
    blk = default_main_program().global_block
    var = blk.create_var(name=name, shape=shape, dtype=dtype,
                         persistable=persistable, stop_gradient=True)
    sb = default_startup_program().global_block
    sb.create_var(name=name, shape=shape, dtype=dtype,
                  persistable=persistable, stop_gradient=True)
    sb.append_op("fill_constant", {}, {"Out": [name]},
                 {"shape": list(shape), "dtype": dtype,
                  "value": float(value)}, infer_shape=False)
    return var


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """reference: layers/tensor.py create_parameter — a free-standing
    trainable parameter."""
    import copy as _copy

    from ..framework.layer_helper import LayerHelper, ParamAttr
    helper = LayerHelper("create_parameter", name=None)
    if attr is None:
        attr = ParamAttr(name=name)
    elif name and not attr.name:
        # never mutate the caller's attr: a shared ParamAttr reused across
        # calls would silently alias every parameter to the first name
        attr = _copy.copy(attr)
        attr.name = name
    return helper.create_parameter(attr, list(shape), dtype,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer)


def load(out, file_path, load_as_fp16=None):
    """reference: layers/io.py load: a load op writing a saved tensor into
    `out` at executor host-op time (ops/io_dist_ops.py load)."""
    helper = LayerHelper("load")
    helper.append_op("load", {}, {"Out": [out.name]},
                     {"file_path": file_path,
                      **({"load_as_fp16": bool(load_as_fp16)}
                         if load_as_fp16 is not None else {})},
                     infer_shape=False)
    return out
