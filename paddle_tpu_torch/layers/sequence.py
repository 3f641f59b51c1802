"""Sequence layers over the dense [b, s, ...] + lengths representation:
sequence_mask, the one of `paddle_tpu/layers/sequence.py` on the NMT
Transformer's and the book models' path (the rest is ROADMAP A.6)."""

from ..framework.layer_helper import LayerHelper

__all__ = ["sequence_mask"]


def sequence_mask(x, maxlen, dtype="float32", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("sequence_mask", {"X": [x.name]}, {"Y": [out.name]},
                     {"maxlen": int(maxlen), "out_dtype": dtype})
    return out
