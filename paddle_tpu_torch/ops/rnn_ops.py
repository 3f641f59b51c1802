"""Recurrent ops: dynamic_lstm, dynamic_gru, simple_rnn, gru_unit.

Port of `paddle_tpu/ops/rnn_ops.py` (with lstm_scan, ragged_flip,
_gru_cell and _ACTS). Reference: operators/lstm_op.cc + math/lstm_compute
(gate order i,c,f,o in paddle; here documented i,f,c,o), gru_op.cc. The JAX
rules run one lax.scan per layer; here each recurrence is a Python loop
over the time axis of torch ops, and the gradient is the registry's
generic `torch.func.vjp` over that loop (BPTT). No torch.nn.LSTM/GRU,
torch._VF or cuDNN RNN: their GRU candidate is r * (h @ W_hn + b_hn) where
JAX's is x_c + (r*h) @ W_c, their gate order differs, and cuDNN zeroes
the state past a packed length where JAX freezes it.

Dense layout: [batch, seq, feat] + optional SequenceLength [batch] mask
(replaces LoD ragged batching). Beyond a sequence's length, state carries
through FROZEN — Hidden[t >= len] repeats the last valid hidden state, so
LastH/LastC and last-step pooling are correct without extra gathers; mask
the output (sequence_unpad / sequence_mask) if zeros are needed.
"""

import torch

from ..framework.registry import register_op


def ragged_flip(x, lengths):
    """Reverse each row's valid prefix [0, len) along axis 1, keeping
    padding in place — the per-sequence reversal a reverse-direction RNN
    needs on right-padded batches (whole-axis flip would move real steps
    past the t<len freeze mask)."""
    if lengths is None:
        return torch.flip(x, dims=[1])
    s = x.shape[1]
    ln = lengths.reshape(-1)
    steps = torch.arange(s, device=x.device)[None, :]
    idx = torch.where(steps < ln[:, None], ln[:, None] - 1 - steps, steps)
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x.ndim - 2)).expand(
        x.shape).long()
    return torch.gather(x, 1, idx)


def _freeze(new, old, t, lengths, dtype):
    """JAX's freeze: m * new + (1 - m) * old with m = (t < length)."""
    m = (t < lengths).to(dtype)[:, None]
    return m * new + (1 - m) * old


def lstm_scan(x, w, bias, h0, c0, lengths=None, use_peepholes=False,
              gate_act="sigmoid", cell_act="tanh", cand_act="tanh",
              is_reverse=False):
    """Shared LSTM recurrence (a loop over the time axis): x [b, s, 4h]
    pre-projected gates in order i, f, c, o; w [h, 4h] recurrent weights.
    With use_peepholes, bias is [1, 7h] = [gate bias 4h | W_ic | W_fc |
    W_oc] (the reference's packing, math/lstm_compute.h): i/f gates peek
    at the PREVIOUS cell state, o at the NEW one."""
    b, s, four_h = x.shape
    h_size = four_h // 4
    if bias is not None:
        bias = bias.reshape(-1)
        gate_bias = bias[:4 * h_size]
        if use_peepholes:
            w_ic = bias[4 * h_size:5 * h_size]
            w_fc = bias[5 * h_size:6 * h_size]
            w_oc = bias[6 * h_size:7 * h_size]
    elif use_peepholes:
        raise ValueError("peephole lstm requires the [1, 7h] Bias input")
    if h0 is None:
        h0 = torch.zeros((b, h_size), dtype=x.dtype, device=x.device)
    if c0 is None:
        c0 = torch.zeros((b, h_size), dtype=x.dtype, device=x.device)
    g_act, c_act, d_act = _ACTS[gate_act], _ACTS[cand_act], _ACTS[cell_act]

    if is_reverse:
        x = ragged_flip(x, lengths)
    h, c = h0, c0
    hs, cs = [], []
    for t in range(s):
        gates = x[:, t] + h @ w
        if bias is not None:
            gates = gates + gate_bias
        i, f, g, o = torch.split(gates, h_size, dim=-1)
        if use_peepholes:
            i = i + w_ic * c
            f = f + w_fc * c
        i = g_act(i)
        f = g_act(f)
        g = c_act(g)
        c_new = f * c + i * g
        if use_peepholes:
            o = o + w_oc * c_new
        o = g_act(o)
        h_new = o * d_act(c_new)
        if lengths is not None:
            c_new = _freeze(c_new, c, t, lengths, x.dtype)
            h_new = _freeze(h_new, h, t, lengths, x.dtype)
        h, c = h_new, c_new
        hs.append(h)
        cs.append(c)
    hidden = torch.stack(hs, dim=1)
    cell = torch.stack(cs, dim=1)
    if is_reverse:
        hidden = ragged_flip(hidden, lengths)
        cell = ragged_flip(cell, lengths)
    return hidden, cell, h, c


@register_op("dynamic_lstm", no_grad_inputs={"SequenceLength"},
             non_diff_outputs={"LastH", "LastC"})
def _dynamic_lstm(ctx, ins, attrs):
    """Input: pre-projected gates [b, s, 4h] (x @ Wx done by an fc outside,
    as in the reference's dynamic_lstm); Weight [h, 4h] recurrent; Bias
    [1, 4h], or [1, 7h] with use_peepholes (reference lstm_op.cc). Gate
    order i, f, c, o. Outputs Hidden [b, s, h], Cell."""
    x = ins["Input"][0]
    lengths = ins["SequenceLength"][0] if "SequenceLength" in ins else None
    hidden, cell, h_last, c_last = lstm_scan(
        x, ins["Weight"][0],
        ins["Bias"][0] if "Bias" in ins else None,
        ins["H0"][0] if "H0" in ins else None,
        ins["C0"][0] if "C0" in ins else None,
        lengths=lengths,
        use_peepholes=attrs.get("use_peepholes", False),
        gate_act=attrs.get("gate_activation", "sigmoid"),
        cell_act=attrs.get("cell_activation", "tanh"),
        cand_act=attrs.get("candidate_activation", "tanh"),
        is_reverse=attrs.get("is_reverse", False))
    return {"Hidden": [hidden], "Cell": [cell],
            "LastH": [h_last], "LastC": [c_last]}


@register_op("dynamic_gru", no_grad_inputs={"SequenceLength"},
             non_diff_outputs={"LastH"})
def _dynamic_gru(ctx, ins, attrs):
    """Input [b, s, 3h] pre-projected; Weight [h, 3h] packed as
    [update|reset | candidate]; gate order u, r, c (reference gru_op.cc)."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    bias = ins["Bias"][0].reshape(-1) if "Bias" in ins else None
    b, s, three_h = x.shape
    h_size = three_h // 3
    lengths = ins["SequenceLength"][0] if "SequenceLength" in ins else None
    h = ins["H0"][0] if "H0" in ins else torch.zeros(
        (b, h_size), dtype=x.dtype, device=x.device)
    hs = []
    for t in range(s):
        h_new, _, _ = _gru_cell(x[:, t], h, w, bias)
        if lengths is not None:
            h_new = _freeze(h_new, h, t, lengths, x.dtype)
        h = h_new
        hs.append(h)
    return {"Hidden": [torch.stack(hs, dim=1)], "LastH": [h]}


@register_op("simple_rnn", no_grad_inputs={"SequenceLength"},
             non_diff_outputs={"LastH"})
def _simple_rnn(ctx, ins, attrs):
    x = ins["Input"][0]
    w = ins["Weight"][0]
    bias = ins["Bias"][0].reshape(-1) if "Bias" in ins else None
    b, s, h_size = x.shape
    lengths = ins["SequenceLength"][0] if "SequenceLength" in ins else None
    h = ins["H0"][0] if "H0" in ins else torch.zeros(
        (b, h_size), dtype=x.dtype, device=x.device)
    act = attrs.get("activation", "tanh")
    actf = torch.tanh if act == "tanh" else torch.relu
    hs = []
    for t in range(s):
        pre = x[:, t] + h @ w
        if bias is not None:
            pre = pre + bias
        h_new = actf(pre)
        if lengths is not None:
            h_new = _freeze(h_new, h, t, lengths, x.dtype)
        h = h_new
        hs.append(h)
    return {"Hidden": [torch.stack(hs, dim=1)], "LastH": [h]}


_ACTS = {"sigmoid": torch.sigmoid,
         "tanh": torch.tanh,
         "relu": torch.relu,
         "identity": lambda v: v}


def _gru_cell(x, h, w, bias, act="tanh", gate_act="sigmoid"):
    """Shared GRU cell: x [b, 3h] pre-projected, w [h, 3h] packed
    [update|reset|candidate], h_new = u*h + (1-u)*c (reference gru
    convention, gru_op.cc / gru_unit_op.cc). Returns (h_new, gates, r*h)."""
    h_size = h.shape[-1]
    ur = x[:, :2 * h_size] + h @ w[:, :2 * h_size]
    if bias is not None:
        ur = ur + bias[:2 * h_size]
    u, r = torch.split(_ACTS[gate_act](ur), h_size, dim=-1)
    cand = x[:, 2 * h_size:] + (r * h) @ w[:, 2 * h_size:]
    if bias is not None:
        cand = cand + bias[2 * h_size:]
    c = _ACTS[act](cand)
    h_new = u * h + (1 - u) * c
    return h_new, torch.cat([u, r, c], dim=-1), r * h


@register_op("gru_unit", non_diff_outputs={"Gate", "ResetHiddenPrev"})
def _gru_unit(ctx, ins, attrs):
    """Single GRU step (reference: gru_unit_op.cc)."""
    h_new, gate, rh = _gru_cell(
        ins["Input"][0], ins["HiddenPrev"][0], ins["Weight"][0],
        ins["Bias"][0].reshape(-1) if "Bias" in ins else None,
        attrs.get("activation", "tanh"),
        attrs.get("gate_activation", "sigmoid"))
    return {"Hidden": [h_new], "Gate": [gate], "ResetHiddenPrev": [rh]}
