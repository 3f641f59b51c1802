"""RNN layers (reference: layers/nn.py dynamic_lstm:…, dynamic_gru, and
the cudnn lstm op), copied from `paddle_tpu/layers/rnn.py`. Input is dense
[batch, seq, feat] (+ optional lengths var); each layer and direction is
one recurrent op (ops/rnn_ops.py), a loop over the time axis."""

from ..framework.layer_helper import LayerHelper, ParamAttr
from ..initializer import Xavier

__all__ = ["dynamic_lstm", "dynamic_gru", "simple_rnn", "lstm"]


def _rnn_op(op_type, input, size, lengths, h0, c0, param_attr, bias_attr,
            helper_name, n_gates, extra_attrs=None):
    helper = LayerHelper(helper_name)
    w = helper.create_parameter(param_attr, [size, n_gates * size],
                                input.dtype, default_initializer=Xavier())
    bias = helper.create_parameter(bias_attr, [1, n_gates * size],
                                   input.dtype, is_bias=True)
    ins = {"Input": [input.name], "Weight": [w.name]}
    if bias is not None:
        ins["Bias"] = [bias.name]
    if lengths is not None:
        ins["SequenceLength"] = [lengths.name]
    if h0 is not None:
        ins["H0"] = [h0.name]
    if c0 is not None:
        ins["C0"] = [c0.name]
    hidden = helper.create_variable_for_type_inference(input.dtype)
    outs = {"Hidden": [hidden.name]}
    last_h = helper.create_variable_for_type_inference(input.dtype, True)
    outs["LastH"] = [last_h.name]
    cell = None
    if op_type == "dynamic_lstm":
        cell = helper.create_variable_for_type_inference(input.dtype)
        last_c = helper.create_variable_for_type_inference(input.dtype,
                                                           True)
        outs["Cell"] = [cell.name]
        outs["LastC"] = [last_c.name]
    helper.append_op(op_type, ins, outs, extra_attrs or {})
    return hidden, cell, last_h


def dynamic_lstm(input, size, sequence_length=None, h0=None, c0=None,
                 param_attr=None, bias_attr=None, use_peepholes=False,
                 is_reverse=False, name=None, need_cell=True):
    """fluid.layers.dynamic_lstm analog. `size` = 4*hidden (as in fluid);
    input must be pre-projected to [b, s, 4*hidden] by an fc.
    need_cell=False returns (h, None) on every path, and on the
    is_reverse path also skips building the cell-state un-reverse op —
    callers that discard the cell (the bidirectional wrapper) would
    otherwise build a dead op (PT-W101)."""
    if is_reverse:
        from .sequence import sequence_reverse
        input = sequence_reverse(input, sequence_length)
    hidden_size = size // 4
    h, c, _ = _rnn_op("dynamic_lstm", input, hidden_size, sequence_length,
                      h0, c0, param_attr, bias_attr, name or "lstm", 4,
                      {"use_peepholes": use_peepholes})
    if is_reverse:
        from .sequence import sequence_reverse
        h = sequence_reverse(h, sequence_length)
        c = sequence_reverse(c, sequence_length) if need_cell else None
    return h, (c if need_cell else None)


def dynamic_gru(input, size, sequence_length=None, h0=None,
                param_attr=None, bias_attr=None, is_reverse=False,
                name=None):
    """fluid.layers.dynamic_gru analog. `size` = hidden; input [b,s,3h]."""
    if is_reverse:
        from .sequence import sequence_reverse
        input = sequence_reverse(input, sequence_length)
    h, _, _ = _rnn_op("dynamic_gru", input, size, sequence_length, h0,
                      None, param_attr, bias_attr, name or "gru", 3)
    if is_reverse:
        from .sequence import sequence_reverse
        h = sequence_reverse(h, sequence_length)
    return h


def simple_rnn(input, size, sequence_length=None, h0=None, param_attr=None,
               bias_attr=None, activation="tanh", name=None):
    h, _, _ = _rnn_op("simple_rnn", input, size, sequence_length, h0, None,
                      param_attr, bias_attr, name or "rnn", 1,
                      {"activation": activation})
    return h


def lstm(input, init_h=None, init_c=None, max_len=None, hidden_size=None,
         num_layers=1, dropout_prob=0.0, is_bidirec=False,
         sequence_length=None, name=None, last_states=True):
    """Multi-layer (optionally bidirectional) LSTM — the cudnn_lstm analog
    (reference: layers/nn.py lstm). Returns (out, last_h, last_c): out is
    [b, s, h*(2 if bidirec else 1)]; last_h/last_c are the top layer's
    forward-direction final states [b, h]. last_states=False skips
    building the final-state extraction ops and returns (out, None,
    None) — unlike the reference's fused cudnn op, our decomposed form
    pays real (dead) ops for discarded states, which the static verifier
    flags as PT-W101."""
    from . import nn as nn_layers
    from .tensor import concat
    from . import nn
    from .sequence import sequence_last_step

    x = input
    fwd = cell = None
    for layer in range(num_layers):
        proj = nn_layers.fc(x, 4 * hidden_size, num_flatten_dims=2,
                            bias_attr=False)
        fwd, cell = dynamic_lstm(proj, 4 * hidden_size,
                                 sequence_length=sequence_length)
        if is_bidirec:
            proj_b = nn_layers.fc(x, 4 * hidden_size, num_flatten_dims=2,
                                  bias_attr=False)
            bwd, _ = dynamic_lstm(proj_b, 4 * hidden_size,
                                  sequence_length=sequence_length,
                                  is_reverse=True, need_cell=False)
            x = concat([fwd, bwd], axis=2)
        else:
            x = fwd
        if dropout_prob > 0 and layer < num_layers - 1:
            x = nn.dropout(x, dropout_prob)
    if not last_states:
        return x, None, None
    # top layer only — the per-layer extraction this loop used to do
    # built dead ops for every non-top layer (PT-W101)
    last_h = sequence_last_step(fwd, sequence_length)
    last_c = sequence_last_step(cell, sequence_length)
    return x, last_h, last_c
