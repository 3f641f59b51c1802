"""Tensor layers: data declaration, fills, casts, shape manipulation,
indexing, random fills, py_func and Print, the tensor-array surface
(create_array, array_write, array_read, array_length,
tensor_array_to_tensor) and load.

Copied from `paddle_tpu/layers/tensor.py`: the same op types, slots and
attrs, so a program built by either DSL serializes alike.
"""

import numpy as np

from ..framework.core import (Variable, convert_np_dtype,
                              default_main_program, unique_name)
from ..framework.layer_helper import LayerHelper

__all__ = ["load",
           "diag", "eye", "linspace", "range", "reverse", "sign",
           "has_inf", "has_nan", "isfinite", "shard_index", "size",
           "create_array", "array_write", "array_read", "array_length",
           "tensor_array_to_tensor",
           "data", "fill_constant", "fill_constant_batch_size_like",
           "zeros", "ones", "zeros_like", "ones_like", "cast", "concat",
           "split", "stack", "unstack", "reshape", "squeeze", "unsqueeze",
           "flatten", "transpose", "slice", "expand", "gather", "gather_nd",
           "scatter", "assign", "shape", "arange", "argmax", "argmin",
           "argsort", "where", "pad", "pad2d", "uniform_random",
           "gaussian_random", "increment", "create_global_var",
           "create_tensor", "flip", "roll", "tile", "py_func", "Print",
           "create_parameter"]

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


def zeros(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 0.0, name)


def ones(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 1.0, name)


def zeros_like(x, name=None):
    helper = LayerHelper("fill_zeros_like", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("fill_zeros_like", {"X": [x.name]}, {"Out": [out.name]})
    return out


def ones_like(x, name=None):
    helper = LayerHelper("fill_any_like", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("fill_any_like", {"X": [x.name]}, {"Out": [out.name]},
                     {"value": 1.0})
    return out


def stack(x, axis=0, name=None):
    helper = LayerHelper("stack", name=name)
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    helper.append_op("stack", {"X": [v.name for v in xs]},
                     {"Y": [out.name]}, {"axis": axis})
    return out


def unstack(x, axis=0, num=None, name=None):
    helper = LayerHelper("unstack", name=name)
    n = num if num is not None else int(x.shape[axis])
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in _builtin_range(n)]
    helper.append_op("unstack", {"X": [x.name]},
                     {"Y": [o.name for o in outs]}, {"axis": axis})
    return outs


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("flatten2", {"X": [x.name]},
                     {"Out": [out.name], "XShape": [xshape.name]},
                     {"axis": axis})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("expand", {"X": [x.name]}, {"Out": [out.name]},
                     {"expand_times": list(expand_times)})
    return out


def tile(x, repeat_times, name=None):
    helper = LayerHelper("tile", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("tile", {"X": [x.name]}, {"Out": [out.name]},
                     {"repeat_times": list(repeat_times)})
    return out


def flip(x, axis, name=None):
    helper = LayerHelper("flip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("flip", {"X": [x.name]}, {"Out": [out.name]},
                     {"axis": axis if isinstance(axis, list) else [axis]})
    return out


def roll(x, shifts, axis, name=None):
    helper = LayerHelper("roll", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("roll", {"X": [x.name]}, {"Out": [out.name]},
                     {"shifts": shifts,
                      "axis": axis if isinstance(axis, list) else [axis]})
    return out


def gather(input, index, name=None):
    helper = LayerHelper("gather", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather", {"X": [input.name], "Index": [index.name]},
                     {"Out": [out.name]})
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather_nd", {"X": [input.name], "Index": [index.name]},
                     {"Out": [out.name]})
    return out


def scatter(input, index, updates, overwrite=True, name=None):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("scatter",
                     {"X": [input.name], "Ids": [index.name],
                      "Updates": [updates.name]},
                     {"Out": [out.name]}, {"overwrite": overwrite})
    return out


def shape(input, name=None):
    helper = LayerHelper("shape", name=name)
    out = helper.create_variable_for_type_inference("int32", True)
    helper.append_op("shape", {"Input": [input.name]}, {"Out": [out.name]})
    return out


def argmin(x, axis=-1, dtype="int64", name=None):
    helper = LayerHelper("arg_min", name=name)
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("arg_min", {"X": [x.name]}, {"Out": [out.name]},
                     {"axis": axis, "dtype": dtype})
    return out


def argsort(x, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    idx = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("argsort", {"X": [x.name]},
                     {"Out": [out.name], "Indices": [idx.name]},
                     {"axis": axis, "descending": descending})
    return out, idx


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("pad", {"X": [x.name]}, {"Out": [out.name]},
                     {"paddings": list(paddings), "pad_value": pad_value})
    return out


def pad2d(x, paddings, mode="constant", pad_value=0.0, name=None):
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("pad2d", {"X": [x.name]}, {"Out": [out.name]},
                     {"paddings": list(paddings), "mode": mode,
                      "pad_value": pad_value})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,
                   name=None):
    helper = LayerHelper("uniform_random", name=name)
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("uniform_random", {}, {"Out": [out.name]},
                     {"shape": list(shape), "dtype": dtype, "min": min,
                      "max": max, "seed": seed})
    return out


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, seed=0,
                    name=None):
    helper = LayerHelper("gaussian_random", name=name)
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("gaussian_random", {}, {"Out": [out.name]},
                     {"shape": list(shape), "dtype": dtype, "mean": mean,
                      "std": std, "seed": seed})
    return out


def create_tensor(dtype, name=None, persistable=False):
    from ..framework.core import default_main_program
    blk = default_main_program().global_block
    return blk.create_var(name=name or unique_name("tensor"), dtype=dtype,
                          persistable=persistable)


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None,
            name=None):
    """Host-Python callback op (reference: layers/nn.py py_func). `out`
    vars must be pre-created with concrete shapes and dtypes, as in the
    reference. backward_func is accepted but the op is not
    differentiable. The function gets numpy arrays and runs on the host
    (ops/tensor_ops.py py_func)."""
    from ..ops.tensor_ops import register_py_func
    helper = LayerHelper("py_func", name=name)
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    for v in outs:
        if v.shape is None or -1 in v.shape:
            raise ValueError(
                f"py_func out var {v.name!r} must have a fully concrete "
                f"shape (got {v.shape}); the host callback's result shape "
                "is fixed at compile time")
    fid = register_py_func(func)
    helper.append_op(
        "py_func", {"X": [v.name for v in xs]},
        {"Out": [v.name for v in outs]},
        {"func_id": fid,
         "out_shapes": [list(v.shape) for v in outs],
         "out_dtypes": [v.dtype for v in outs]},
        infer_shape=False)
    return out


def Print(input, first_n=-1, message="", summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both", name=None, print_stats=True):
    """reference: layers/control_flow.py Print: identity on the data
    flow with a host-side debug print (ops/misc_ops.py print). It prints
    on every run (first_n is accepted, not honoured); print_stats=True
    prints shape/mean/min/max plus the first `summarize` values, False
    the raw values only; the LoD and phase arguments are accepted
    no-ops."""
    helper = LayerHelper("print", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("print", {"X": [input.name]}, {"Out": [out.name]},
                     {"message": message or input.name,
                      "summarize": summarize,
                      "print_tensor_stats": bool(print_stats)})
    return out


def _simple_op(op_type, ins, attrs, out_dtype, helper_name=None):
    helper = LayerHelper(helper_name or op_type)
    out = helper.create_variable_for_type_inference(out_dtype)
    helper.append_op(op_type, ins, {"Out": [out.name]}, attrs)
    return out


def diag(diagonal, name=None):
    """reference: layers/tensor.py diag."""
    return _simple_op("diag", {"Diagonal": [diagonal.name]}, {},
                      diagonal.dtype)


def eye(num_rows, num_columns=None, batch_shape=None, dtype="float32",
        name=None):
    """reference: layers/tensor.py eye. batch_shape tiles leading dims."""
    out = _simple_op("eye", {}, {"num_rows": int(num_rows),
                                 "num_columns": int(num_columns
                                                    if num_columns else -1),
                                 "dtype": dtype}, dtype)
    if batch_shape:
        from . import tensor as _t
        for _ in batch_shape:
            out = _t.unsqueeze(out, [0])
        out = _t.expand(out, list(batch_shape) + [1, 1])
    return out


def linspace(start, stop, num, dtype="float32", name=None):
    """reference: layers/tensor.py linspace; num must be static."""
    s = start if isinstance(start, Variable) else fill_constant(
        [1], dtype, float(start))
    e = stop if isinstance(stop, Variable) else fill_constant(
        [1], dtype, float(stop))
    return _simple_op("linspace", {"Start": [s.name], "Stop": [e.name]},
                      {"num": int(num)}, dtype)


def range(start, end, step, dtype="float32", name=None):
    """reference: layers/tensor.py range. Bounds must be python numbers
    (a static output shape): delegates to arange."""
    if any(isinstance(v, Variable) for v in (start, end, step)):
        raise ValueError("range needs static python bounds "
                         "(a tensor bound would be a dynamic shape)")
    return arange(start, end, step, dtype, name)


def reverse(x, axis, name=None):
    """reference: layers/tensor.py reverse."""
    if isinstance(axis, int):
        axis = [axis]
    return _simple_op("reverse", {"X": [x.name]},
                      {"axis": [int(a) for a in axis]}, x.dtype)


def sign(x, name=None):
    """reference: layers/nn.py sign."""
    return _simple_op("sign", {"X": [x.name]}, {}, x.dtype)


def has_inf(x, name=None):
    """reference: layers/tensor.py has_inf — any(isinf(x)), shape [1]."""
    return _simple_op("isinf", {"X": [x.name]}, {}, "bool")


def has_nan(x, name=None):
    """reference: layers/tensor.py has_nan."""
    return _simple_op("isnan", {"X": [x.name]}, {}, "bool")


def isfinite(x, name=None):
    """reference: layers/tensor.py isfinite."""
    return _simple_op("isfinite", {"X": [x.name]}, {}, "bool")


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """reference: layers/nn.py shard_index."""
    return _simple_op("shard_index", {"X": [input.name]},
                      {"index_num": int(index_num),
                       "nshards": int(nshards),
                       "shard_id": int(shard_id),
                       "ignore_value": int(ignore_value)}, input.dtype)


def size(input, name=None):
    """reference: layers/nn.py size — total element count, int64 [1]."""
    return _simple_op("size", {"Input": [input.name]}, {}, "int64", "size")


def create_array(dtype):
    """reference: layers/control_flow.py create_array — a tensor-array var
    (a python tuple of arrays in the trace env, lod_array_ops.py)."""
    helper = LayerHelper("array")
    return helper.main_program.current_block().create_var(
        name=unique_name("array"), dtype=dtype, type="lod_tensor_array",
        shape=None)


def array_write(x, i, array=None):
    """reference: control_flow.py array_write (write_to_array op)."""
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op("write_to_array", {"X": [x.name], "I": [i.name]},
                     {"Out": [array.name]}, {}, infer_shape=False)
    return array


def array_read(array, i, shape=None):
    """reference: control_flow.py array_read (read_from_array op). The
    element shape is runtime-determined; pass `shape` when a downstream
    build-time op needs it."""
    helper = LayerHelper("array_read")
    out = helper.main_program.current_block().create_var(
        name=unique_name("array_read"), dtype=array.dtype,
        shape=tuple(shape) if shape is not None else None)
    helper.append_op("read_from_array", {"X": [array.name], "I": [i.name]},
                     {"Out": [out.name]}, {}, infer_shape=False)
    return out


def array_length(array):
    """reference: control_flow.py array_length."""
    helper = LayerHelper("array_length")
    out = helper.main_program.current_block().create_var(
        name=unique_name("array_length"), dtype="int64", shape=(1,))
    helper.append_op("lod_array_length", {"X": [array.name]},
                     {"Out": [out.name]}, {}, infer_shape=False)
    return out


def tensor_array_to_tensor(input, axis=1, name=None, use_stack=False,
                           shape=None):
    """reference: layers/tensor.py tensor_array_to_tensor (shapes are
    runtime-determined; pass `shape` for build-time consumers)."""
    helper = LayerHelper("tensor_array_to_tensor")
    blk = helper.main_program.current_block()
    out = blk.create_var(name=unique_name("ta2t"), dtype=input.dtype,
                         shape=tuple(shape) if shape is not None else None)
    idx = blk.create_var(name=unique_name("ta2t_idx"), dtype="int32",
                         shape=None)
    helper.append_op("tensor_array_to_tensor", {"X": [input.name]},
                     {"Out": [out.name], "OutIndex": [idx.name]},
                     {"axis": int(axis), "use_stack": bool(use_stack)},
                     infer_shape=False)
    return out, idx
