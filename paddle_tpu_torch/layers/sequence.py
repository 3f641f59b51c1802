"""Sequence layers over the dense [b, s, ...] + lengths representation
(reference: layers/sequence ops exposed via layers/nn.py). Copied from
`paddle_tpu/layers/sequence.py`."""

from ..framework.layer_helper import LayerHelper

__all__ = ["sequence_mask", "sequence_pool", "sequence_softmax",
           "sequence_reverse", "sequence_expand", "sequence_concat",
           "sequence_last_step", "sequence_first_step", "sequence_slice",
           "sequence_enumerate", "sequence_erase", "sequence_pad",
           "sequence_unpad", "sequence_conv", "sequence_expand_as",
           "sequence_reshape", "sequence_scatter"]


def _op(helper_name, op_type, ins, outs_spec, attrs=None, dtypes=None):
    helper = LayerHelper(helper_name)
    outs = {}
    ret = []
    for i, slot in enumerate(outs_spec):
        dt = (dtypes or {}).get(slot, "float32")
        v = helper.create_variable_for_type_inference(dt)
        outs[slot] = [v.name]
        ret.append(v)
    helper.append_op(op_type, ins, outs, attrs or {})
    return ret[0] if len(ret) == 1 else ret


def sequence_mask(x, maxlen, dtype="float32", name=None):
    return _op("sequence_mask", "sequence_mask", {"X": [x.name]}, ["Y"],
               {"maxlen": int(maxlen), "out_dtype": dtype},
               {"Y": dtype})


def _with_len(x, lengths):
    ins = {"X": [x.name]}
    if lengths is not None:
        ins["Length"] = [lengths.name]
    return ins


def sequence_pool(input, pool_type, lengths=None, name=None):
    return _op("sequence_pool", "sequence_pool", _with_len(input, lengths),
               ["Out"], {"pooltype": pool_type.upper()},
               {"Out": input.dtype})


def sequence_last_step(input, lengths=None):
    return sequence_pool(input, "last", lengths)


def sequence_first_step(input, lengths=None):
    return sequence_pool(input, "first", lengths)


def sequence_softmax(input, lengths=None, name=None):
    return _op("sequence_softmax", "sequence_softmax",
               _with_len(input, lengths), ["Out"], {},
               {"Out": input.dtype})


def sequence_reverse(x, lengths=None, name=None):
    return _op("sequence_reverse", "sequence_reverse", _with_len(x, lengths),
               ["Y"], {}, {"Y": x.dtype})


def sequence_expand(x, y, ref_level=-1, name=None):
    return _op("sequence_expand", "sequence_expand",
               {"X": [x.name], "Y": [y.name]}, ["Out"],
               {"ref_level": int(ref_level)}, {"Out": x.dtype})


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat")
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("sequence_concat",
                     {"X": [v.name for v in input]}, {"Out": [out.name]})
    return out


def sequence_slice(input, offset, length, name=None):
    return _op("sequence_slice", "sequence_slice", {"X": [input.name]},
               ["Out"], {"offset": int(offset), "length": int(length)},
               {"Out": input.dtype})


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    return _op("sequence_enumerate", "sequence_enumerate",
               {"X": [input.name]}, ["Out"],
               {"win_size": win_size, "pad_value": pad_value},
               {"Out": input.dtype})


def sequence_erase(input, tokens, name=None):
    return _op("sequence_erase", "sequence_erase", {"X": [input.name]},
               ["Out"], {"tokens": list(tokens)}, {"Out": input.dtype})


def sequence_pad(x, pad_value=None, maxlen=None, lengths=None, name=None):
    ins = _with_len(x, lengths)
    return _op("sequence_pad", "sequence_pad", ins, ["Out", "Length"], {},
               {"Out": x.dtype, "Length": "int64"})


def sequence_unpad(x, length, name=None):
    return _op("sequence_unpad", "sequence_unpad",
               {"X": [x.name], "Length": [length.name]}, ["Out"], {},
               {"Out": x.dtype})


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None, lengths=None):
    """Context-window convolution over padded sequences (reference:
    layers/nn.py sequence_conv over LoD input; here [b, T, d] + optional
    lengths zeroing the padded steps)."""
    from ..framework.layer_helper import LayerHelper
    helper = LayerHelper(name or "sequence_conv")
    d = input.shape[-1]
    filt = helper.create_parameter(param_attr,
                                   [filter_size * d, num_filters])
    ins = {"X": [input.name], "Filter": [filt.name]}
    if lengths is not None:
        ins["XLength"] = [lengths.name]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_conv", ins, {"Out": [out.name]},
                     {"context_length": filter_size,
                      "context_start": -(filter_size // 2)})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], is_bias=True)
        out = helper.append_bias_op(out, b, dim_start=2)
    return helper.append_activation(out, act)


def sequence_expand_as(x, y, name=None):
    """reference: layers/nn.py sequence_expand_as."""
    return _op("sequence_expand_as", "sequence_expand_as",
               {"X": [x.name], "Y": [y.name]}, ["Out"], {},
               {"Out": x.dtype})


def sequence_reshape(input, new_dim):
    """reference: layers/nn.py sequence_reshape."""
    return _op("sequence_reshape", "sequence_reshape",
               {"X": [input.name]}, ["Out"], {"new_dim": int(new_dim)},
               {"Out": input.dtype})


def sequence_scatter(input, index, updates, name=None):
    """reference: layers/nn.py sequence_scatter."""
    return _op("sequence_scatter", "sequence_scatter",
               {"X": [input.name], "Ids": [index.name],
                "Updates": [updates.name]}, ["Out"], {},
               {"Out": input.dtype})
