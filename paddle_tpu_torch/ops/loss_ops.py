"""Structured-prediction and sampled losses: CTC, linear-chain CRF, NCE,
hierarchical sigmoid.

Reference: operators/warpctc_op.cc (external warp-ctc library),
operators/linear_chain_crf_op.cc + crf_decoding_op.cc,
operators/nce_op.cc, operators/hierarchical_sigmoid_op.cc.

Port of `paddle_tpu/ops/loss_ops.py`. Each dynamic-programming recursion
(CTC forward, CRF forward and Viterbi) is JAX's log-space recursion over
the time axis, here a Python loop of torch ops, batched over the batch
dim; ragged sequences arrive padded with explicit length tensors. The
gradients of warpctc, linear_chain_crf and hierarchical_sigmoid are the
generic `torch.func.vjp` over the rule, as JAX's are `jax.vjp` through its
scan; CTC is JAX's own recursion, not `torch.nn.functional.ctc_loss`, so
it gives JAX's values and gradients, blanks and lengths included. nce
draws its negatives from the run's generator and saves them for its
explicit gradient, as dropout saves its mask.
"""

import math

import torch
import torch.nn.functional as F

from ..framework.registry import register_op

_NEG_INF = -1e30


def _logsumexp(a, b):
    # double-where: sanitize the dead branch's INPUTS too, or its log(0)
    # poisons the vjp with NaNs (the standard where-gradient trap)
    m = torch.maximum(a, b)
    dead = m <= _NEG_INF / 2
    a_s = torch.where(dead, 0.0, a)
    b_s = torch.where(dead, 0.0, b)
    m_s = torch.where(dead, 0.0, m)
    out = m_s + torch.log(torch.exp(a_s - m_s) + torch.exp(b_s - m_s))
    return torch.where(dead, _NEG_INF, out)


def _neg(b, n, like):
    return torch.full((b, n), _NEG_INF, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# CTC (warpctc analog)
# ---------------------------------------------------------------------------

@register_op("warpctc", no_grad_inputs={"Label", "LogitsLength",
                                        "LabelLength"})
def _warpctc(ctx, ins, attrs):
    """CTC loss. Logits [b, T, C] (raw, softmax applied internally like
    warp-ctc), Label [b, L] padded, LogitsLength [b], LabelLength [b].
    blank index from attrs (default 0). Out: Loss [b, 1].

    The classic alpha recursion over the extended sequence
    (blank, l1, blank, l2, ... blank) of length S = 2L+1, one step a
    frame; a row's alpha is frozen past its length."""
    logits = ins["Logits"][0]
    labels = ins["Label"][0].long()
    logit_len = ins["LogitsLength"][0].reshape(-1).long()
    label_len = ins["LabelLength"][0].reshape(-1).long()
    blank = int(attrs.get("blank", 0))
    b, t_max, _ = logits.shape
    l_max = labels.shape[1]
    s_max = 2 * l_max + 1
    dev = logits.device

    logp = torch.log_softmax(logits.float(), dim=-1)

    # extended label sequence per batch row: [blank, l1, blank, ...]
    ext = torch.full((b, s_max), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    pos = torch.arange(s_max, device=dev)
    valid_s = pos < (2 * label_len[:, None] + 1)
    # can we skip from s-2 (same-label / blank constraint)?
    skip_ok = torch.zeros((b, s_max), dtype=torch.bool, device=dev)
    skip_ok[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    # every frame's emission of every extended position, gathered once and
    # split into frames once (a slice a step would make its gradient write
    # a whole (b, T, S) buffer a step)
    emit = logp.gather(2, ext[:, None, :].expand(b, t_max, s_max)).unbind(1)
    live = (torch.arange(t_max, device=dev)[None, :]
            < logit_len[:, None]).unbind(1)

    first = logp[:, 0, blank:blank + 1]
    second = torch.where(label_len[:, None] > 0, emit[0][:, 1:2],
                         _NEG_INF) if s_max > 1 else first[:, :0]
    alpha = torch.cat([first, second, _neg(b, s_max - 2, logp)],
                      dim=1)[:, :s_max]
    for t in range(1, t_max):
        prev1 = torch.cat([_neg(b, 1, alpha), alpha[:, :-1]], dim=1)
        prev2 = torch.cat([_neg(b, 2, alpha), alpha[:, :-2]],
                          dim=1)[:, :s_max]
        acc = _logsumexp(alpha, prev1)
        acc = torch.where(skip_ok, _logsumexp(acc, prev2), acc)
        new = torch.where(valid_s, acc + emit[t], _NEG_INF)
        # frozen past the sequence end
        alpha = torch.where(live[t][:, None], new, alpha)
    end1 = 2 * label_len          # last blank
    end2 = 2 * label_len - 1      # last label
    a1 = alpha.gather(1, end1[:, None])[:, 0]
    a2 = torch.where(label_len > 0,
                     alpha.gather(1, end2.clamp(min=0)[:, None])[:, 0],
                     _NEG_INF)
    loss = -_logsumexp(a1, a2)
    if attrs.get("norm_by_times", False):
        loss = loss / logit_len.float().clamp(min=1.0)
    return {"Loss": [loss[:, None]]}


# ---------------------------------------------------------------------------
# linear-chain CRF
# ---------------------------------------------------------------------------

def _crf_split_transition(trans):
    """Paddle layout: Transition [(C+2), C]: row 0 = start weights,
    row 1 = stop weights, rows 2.. = [C, C] transitions."""
    return trans[0], trans[1], trans[2:]


@register_op("linear_chain_crf", no_grad_inputs={"Label", "Length"})
def _linear_chain_crf(ctx, ins, attrs):
    """Emission [b, T, C], Transition [(C+2), C], Label [b, T],
    Length [b]. Outputs LogLikelihood [b, 1] (the layer negates it for
    the loss, matching linear_chain_crf_op.cc semantics)."""
    em = ins["Emission"][0].float()
    trans = ins["Transition"][0].float()
    labels = ins["Label"][0].long()
    lens = ins["Length"][0].reshape(-1).long()
    start_w, stop_w, tr = _crf_split_transition(trans)
    b, t_max, c = em.shape
    dev = em.device

    # path score
    em_lab = em.gather(2, labels[:, :, None])[:, :, 0]
    mask = (torch.arange(t_max, device=dev)[None, :]
            < lens[:, None]).float()
    em_score = (em_lab * mask).sum(1)
    pair_sc = tr[labels[:, :-1], labels[:, 1:]]
    trans_score = (pair_sc * mask[:, 1:]).sum(1)
    first = labels[:, 0]
    last = labels.gather(1, (lens - 1).clamp(min=0)[:, None])[:, 0]
    path = em_score + trans_score + start_w[first] + stop_w[last]

    # partition function (forward algorithm), over the frames split once
    frames = em.unbind(1)
    alpha = start_w[None, :] + frames[0]
    for t in range(1, t_max):
        nxt = torch.logsumexp(alpha[:, :, None] + tr[None, :, :],
                              dim=1) + frames[t]
        alpha = torch.where((t < lens)[:, None], nxt, alpha)
    logz = torch.logsumexp(alpha + stop_w[None, :], dim=1)
    return {"LogLikelihood": [(path - logz)[:, None]]}


@register_op("crf_decoding", not_differentiable=True, grad_free=True)
def _crf_decoding(ctx, ins, attrs):
    """Viterbi decode (reference crf_decoding_op.cc). Same inputs minus
    Label; Out: ViterbiPath [b, T] (zeros past each length). Ties go to
    the lowest label, as jnp.argmax's."""
    em = ins["Emission"][0].float()
    trans = ins["Transition"][0].float()
    lens = ins["Length"][0].reshape(-1).long()
    start_w, stop_w, tr = _crf_split_transition(trans)
    b, t_max, c = em.shape
    dev = em.device

    delta = start_w[None, :] + em[:, 0, :]
    back = []
    for t in range(1, t_max):
        scores = delta[:, :, None] + tr[None, :, :]       # [b, c_prev, c]
        best_prev = torch.argmax(scores, dim=1)          # [b, c]
        nxt = scores.amax(dim=1) + em[:, t, :]
        keep = (t < lens)[:, None]
        delta = torch.where(keep, nxt, delta)
        back.append(torch.where(keep, best_prev, -1))
    # pick the best final state at each row's length end
    final = delta + stop_w[None, :]
    state = torch.argmax(final, dim=1)                    # [b]
    states = [state]
    for t in range(t_max - 2, -1, -1):
        prev = back[t].gather(1, state[:, None])[:, 0]
        # before the row's end, pointers are -1 (frozen): keep state
        state = torch.where(prev < 0, state, prev)
        states.append(state)
    path = torch.stack(states[::-1], dim=1)               # [b, T]
    mask = torch.arange(t_max, device=dev)[None, :] < lens[:, None]
    return {"ViterbiPath": [torch.where(mask, path, 0).long()]}


# ---------------------------------------------------------------------------
# NCE + hierarchical sigmoid (sampled losses for huge softmaxes)
# ---------------------------------------------------------------------------

def _nce_forward(x, w, bias, label, neg):
    """Deterministic NCE cost given already-sampled negatives."""
    num_neg = neg.shape[1]
    c = w.shape[0]
    logq = torch.log(torch.tensor(num_neg / c, dtype=torch.float32,
                                  device=x.device))

    def score(idx):
        s = torch.einsum("bd,b...d->b...", x.float(), w[idx].float())
        if bias is not None:
            s = s + bias[idx]
        return s

    pos = score(label) - logq
    negs = score(neg.long()) - logq
    loss = -F.logsigmoid(pos) - F.logsigmoid(-negs).sum(-1)
    return loss[:, None]


def _nce_grad_maker(op, block, no_grad_set):
    from ..framework.core import grad_var_name
    ins = {"Input": op.input("Input"), "Weight": op.input("Weight"),
           "Label": op.input("Label"),
           "Negatives": op.output("Negatives"),
           "Cost@GRAD": [grad_var_name(op.output("Cost")[0])]}
    outs = {"Input@GRAD": [grad_var_name(op.input("Input")[0])],
            "Weight@GRAD": [grad_var_name(op.input("Weight")[0])]}
    if op.input("Bias"):
        ins["Bias"] = op.input("Bias")
        outs["Bias@GRAD"] = [grad_var_name(op.input("Bias")[0])]
    return [{"type": "nce_grad", "inputs": ins, "outputs": outs,
             "attrs": dict(op.attrs)}]


def _nce_grad_lower(ctx, ins, attrs):
    """Recompute the NCE cost with the SAVED negatives (the dropout-Mask
    pattern: sampling happened once in forward) and vjp through it."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    bias = ins.get("Bias", [None])[0]
    label = ins["Label"][0].reshape(-1).long()
    neg = ins["Negatives"][0]
    og = ins["Cost@GRAD"][0].float()

    if bias is None:
        _, vjp = torch.func.vjp(
            lambda xv, wv: _nce_forward(xv, wv, None, label, neg), x, w)
        gx, gw = vjp(og)
        return {"Input@GRAD": [gx], "Weight@GRAD": [gw]}
    _, vjp = torch.func.vjp(
        lambda xv, wv, bv: _nce_forward(xv, wv, bv, label, neg), x, w, bias)
    gx, gw, gb = vjp(og)
    return {"Input@GRAD": [gx], "Weight@GRAD": [gw], "Bias@GRAD": [gb]}


@register_op("nce", no_grad_inputs={"Label"}, stateful=True,
             non_diff_outputs={"Negatives"}, grad_maker=_nce_grad_maker,
             grad_lower=_nce_grad_lower)
def _nce(ctx, ins, attrs):
    """Noise-contrastive estimation (reference nce_op.cc), uniform noise
    sampler. Input [b, d], Weight [C, d], Bias [C], Label [b, 1].
    Outputs Cost [b, 1] and the sampled Negatives [b, k] int32, drawn from
    the run's generator (saved for the gradient, like dropout's Mask)."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    bias = ins.get("Bias", [None])[0]
    label = ins["Label"][0].reshape(-1).long()
    num_neg = int(attrs.get("num_neg_samples", 10))
    neg = torch.randint(0, w.shape[0], (x.shape[0], num_neg),
                        generator=ctx.rng(), device=x.device,
                        dtype=torch.int32)
    return {"Cost": [_nce_forward(x, w, bias, label, neg)],
            "Negatives": [neg]}


@register_op("hierarchical_sigmoid", no_grad_inputs={"Label"})
def _hsigmoid(ctx, ins, attrs):
    """Hierarchical sigmoid over the default complete binary tree
    (reference hierarchical_sigmoid_op.cc non-custom-tree path): classes
    are leaves of a heap-shaped tree with num_classes-1 internal nodes; W
    is [num_classes - 1, d], Bias [num_classes - 1]. Cost [b, 1]."""
    x = ins["X"][0]
    w = ins["W"][0]
    bias = ins.get("Bias", [None])[0]
    label = ins["Label"][0].reshape(-1).long()
    num_classes = int(attrs["num_classes"])
    depth = max(1, math.ceil(math.log2(num_classes)))

    # heap indexing: leaf node id = label + num_classes - 1; walk to root
    node = label + num_classes - 1
    loss = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for _ in range(depth):
        parent = (node - 1) // 2
        is_right = node % 2 == 0   # right child has even heap index
        active = node > 0
        up = parent.clamp(min=0)
        s = torch.einsum("bd,bd->b", x, w[up])
        if bias is not None:
            s = s + bias[up]
        # sigmoid code: left -> sigmoid(s), right -> sigmoid(-s)
        step_loss = -F.logsigmoid(torch.where(is_right, -s, s))
        loss = loss + torch.where(active, step_loss, 0.0)
        node = up
    return {"Cost": [loss[:, None]]}
