"""LoD / tensor-array family + in-graph decoding ops.

Port of `paddle_tpu/ops/lod_array_ops.py`, all 17 ops, with their
no_grad_inputs / non_diff_outputs. Reference:
paddle/fluid/operators/controlflow/ (lod_tensor_to_array,
array_to_lod_tensor, split/merge_lod_tensor, shrink_rnn_memory...),
lod_rank_table_op.cc, beam_search_op.cc, ctc_align_op.cc.

LoD redesign recap (lod_tensor.py): ragged batches are dense padded
tensors + a per-row lengths vector. A TENSOR ARRAY value is a python
tuple of tensors in the environment; a RANK TABLE value is an (indices,
lengths) pair sorted by length descending, exactly the information the
reference's LoDRankTable holds. Sorts are stable and top-k ties go to the
lower index, as in the JAX rules. Index outputs keep the dtypes the JAX
rules ask for (int64 where they cast to int64; JAX without x64 holds those
as int32).
"""

import torch

from ..framework.registry import get_op_def, register_op


def _rows(mask, ndim):
    return mask.reshape((-1,) + (1,) * (ndim - 1))


@register_op("lod_reset", no_grad_inputs={"Y"})
def _lod_reset(ctx, ins, attrs):
    """reference: lod_reset_op.cc — re-label the sequence segmentation.
    Values are unchanged; the new lengths ride alongside (Y or attr)."""
    return {"Out": [ins["X"][0]]}


@register_op("lod_rank_table", not_differentiable=True, grad_free=True)
def _lod_rank_table(ctx, ins, attrs):
    """X + XLength [n] -> rank table (indices sorted by length desc,
    stable), stored as an (indices, sorted_lengths) tuple."""
    lengths = ins["XLength"][0].reshape(-1).to(torch.int32)
    order = torch.argsort(-lengths, stable=True)
    return {"Out": [(order.to(torch.int32), lengths[order])]}


@register_op("max_sequence_len", not_differentiable=True, grad_free=True)
def _max_sequence_len(ctx, ins, attrs):
    table = ins["RankTable"][0]
    return {"Out": [table[1][0].to(torch.int64)[None]]}


@register_op("lod_tensor_to_array", not_differentiable=True,
             grad_free=True)
def _lod_tensor_to_array(ctx, ins, attrs):
    """X [b, T, ...] + RankTable -> array of T per-step slices in rank
    order (the DynamicRNN input layout): step t holds rows whose length
    > t, here fixed-size [b, ...] (frozen rows padded)."""
    x = ins["X"][0]
    order = ins["RankTable"][0][0].long()
    xr = x[order]                           # rank-sorted rows
    return {"Out": [tuple(xr[:, t] for t in range(x.shape[1]))]}


@register_op("array_to_lod_tensor", not_differentiable=True,
             grad_free=True)
def _array_to_lod_tensor(ctx, ins, attrs):
    """Inverse of lod_tensor_to_array: stack steps, undo rank order."""
    steps = ins["X"][0]
    order = ins["RankTable"][0][0].long()
    stacked = torch.stack(steps, dim=1)     # [b, T, ...]
    return {"Out": [stacked[torch.argsort(order)]]}


@register_op("lod_array_length", not_differentiable=True, grad_free=True)
def _lod_array_length(ctx, ins, attrs):
    arr = ins["X"][0]
    return {"Out": [torch.tensor([len(arr)], dtype=torch.int64,
                                 device=ctx.device)]}


@register_op("split_lod_tensor", no_grad_inputs={"Mask"})
def _split_lod_tensor(ctx, ins, attrs):
    """reference: controlflow/split_lod_tensor_op.cc — route rows by a
    bool mask. Fixed-size: both outputs keep the full shape with
    non-selected rows zeroed (the IfElse scatter/gather redesign)."""
    x = ins["X"][0]
    m = _rows(ins["Mask"][0].reshape(-1).to(torch.bool), x.ndim)
    zero = torch.zeros_like(x)
    return {"OutTrue": [torch.where(m, x, zero)],
            "OutFalse": [torch.where(m, zero, x)]}


@register_op("merge_lod_tensor", no_grad_inputs={"Mask"})
def _merge_lod_tensor(ctx, ins, attrs):
    """Row-wise inverse of split_lod_tensor."""
    t, f = ins["InTrue"][0], ins["InFalse"][0]
    m = _rows(ins["Mask"][0].reshape(-1).to(torch.bool), t.ndim)
    return {"Out": [torch.where(m, t, f)]}


@register_op("tensor_array_to_tensor")
def _tensor_array_to_tensor(ctx, ins, attrs):
    arr = ins["X"][0]
    axis = int(attrs.get("axis", 0))
    if attrs.get("use_stack", False):
        out = torch.stack(arr, dim=axis)
    else:
        out = torch.cat(arr, dim=axis)
    return {"Out": [out],
            "OutIndex": [torch.tensor([a.shape[axis] for a in arr],
                                      dtype=torch.int32,
                                      device=out.device)]}


@register_op("reorder_lod_tensor_by_rank", no_grad_inputs={"RankTable"})
def _reorder_lod_tensor_by_rank(ctx, ins, attrs):
    order = ins["RankTable"][0][0].long()
    return {"Out": [ins["X"][0][order]]}


@register_op("shrink_rnn_memory", no_grad_inputs={"RankTable", "I"})
def _shrink_rnn_memory(ctx, ins, attrs):
    """reference: controlflow/shrink_rnn_memory_op.cc — at step I, only
    sequences with length > I stay active. Fixed-size: inactive rows are
    zeroed instead of dropped (the batch dim stays static)."""
    x = ins["X"][0]
    step = ins["I"][0].reshape(()).to(torch.int32)
    lengths = ins["RankTable"][0][1]            # rank-sorted lengths
    active = _rows(lengths > step, x.ndim)
    return {"Out": [torch.where(active, x, torch.zeros_like(x))]}


@register_op("rnn_memory_helper")
def _rnn_memory_helper(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


# ---------------------------------------------------------------------------
# in-graph beam search (reference: beam_search_op.cc, the on-device
# variant of layers/decode.py's host loop)
# ---------------------------------------------------------------------------

@register_op("beam_search", not_differentiable=True, grad_free=True)
def _beam_search(ctx, ins, attrs):
    """One beam-search step. Dense redesign of the LoD formulation:
    pre_ids [b, bw], pre_scores [b, bw], scores [b, bw, V] (log-probs).
    Outputs selected_ids/selected_scores [b, bw] + parent_idx [b, bw].
    Finished beams (pre_id == end_id) keep their score and propagate.
    Top-k by a stable descending sort: ties go to the lower flat index,
    as lax.top_k's."""
    pre_ids = ins["pre_ids"][0].to(torch.int32)
    pre_scores = ins["pre_scores"][0]
    scores = ins["scores"][0]
    end_id = int(attrs.get("end_id", 0))
    b, bw, v = scores.shape
    beam_size = int(attrs.get("beam_size", bw))

    finished = pre_ids == end_id
    # finished beams: only the end_id continuation, carrying the score
    cont = pre_scores[:, :, None] + scores
    only_end = torch.full_like(cont, -1e20)
    only_end[:, :, end_id] = pre_scores
    total = torch.where(finished[:, :, None], only_end, cont)

    flat = total.reshape(b, bw * v)
    top_s, top_i = torch.sort(flat, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :beam_size], top_i[:, :beam_size]
    return {"selected_ids": [(top_i % v).to(torch.int64)],
            "selected_scores": [top_s],
            "parent_idx": [(top_i // v).to(torch.int32)]}


@register_op("beam_state_gather", no_grad_inputs={"Parent"})
def _beam_state_gather(ctx, ins, attrs):
    """Reorder per-beam state rows by the beam_search op's parent_idx:
    Out[b, k, ...] = State[b, Parent[b, k], ...].  State may be flat
    [b*bw, ...] with attr beam_size (the folded-batch layout user RNN code
    computes in); the output keeps the input's layout."""
    state = ins["State"][0]
    parent = ins["Parent"][0].long()
    b, bw = parent.shape
    structured = state.ndim >= 2 and tuple(state.shape[:2]) == (b, bw)
    if not structured:
        if state.shape[0] != b * bw:
            raise ValueError(
                f"beam_state_gather: State leading dim {state.shape[0]} is "
                f"neither [b, bw]={b, bw} nor b*bw={b * bw}")
        state = state.reshape((b, bw) + tuple(state.shape[1:]))
    idx = parent.reshape((b, bw) + (1,) * (state.ndim - 2)).expand(
        (b, bw) + tuple(state.shape[2:]))
    out = torch.gather(state, 1, idx)
    if not structured:
        out = out.reshape((b * bw,) + tuple(out.shape[2:]))
    return {"Out": [out]}


@register_op("beam_search_decode", not_differentiable=True, grad_free=True)
def _beam_search_decode(ctx, ins, attrs):
    """Backtrace stacked per-step (ids, parents) into full sequences
    (reference: beam_search_decode_op.cc). Ids/ParentIdx [T, b, bw] ->
    SentenceIds [T, b, bw]. Delegates to the gather_tree rule — gather the
    token at the CURRENT beam, then hop to its parent."""
    ids = ins["Ids"][0].to(torch.int64)
    parents = ins["ParentIdx"][0].to(torch.int64)
    scores = ins.get("Scores", [None])[0]
    gt = get_op_def("gather_tree").lower
    out = gt(ctx, {"Ids": [ids], "Parents": [parents]}, {})["Out"][0]
    res = {"SentenceIds": [out.to(torch.int64)]}
    if scores is not None:
        # scores ride the SAME parent pointers as the ids — emitting them
        # un-backtraced would misalign score[t] with the token actually
        # on that beam's path
        res["SentenceScores"] = [gt(
            ctx, {"Ids": [scores], "Parents": [parents]}, {})["Out"][0]]
    return res


@register_op("ctc_align", not_differentiable=True, grad_free=True)
def _ctc_align(ctx, ins, attrs):
    """reference: ctc_align_op.h — collapse repeats then drop blanks.
    Dense redesign: Input [b, T] + InputLength [b] -> Output [b, T]
    padded with `padding_value` + OutputLength [b]."""
    x = ins["Input"][0].to(torch.int32)
    blank = int(attrs.get("blank", 0))
    merge = bool(attrs.get("merge_repeated", True))
    pad = int(attrs.get("padding_value", 0))
    b, t = x.shape
    steps = torch.arange(t, device=x.device)[None, :]
    lengths = (ins["InputLength"][0].reshape(-1).to(torch.int32)
               if "InputLength" in ins else
               torch.full((b,), t, dtype=torch.int32, device=x.device))

    in_range = steps < lengths[:, None]
    prev = torch.cat([torch.full((b, 1), -1, dtype=torch.int32,
                                 device=x.device), x[:, :-1]], dim=1)
    keep = (x != blank) & in_range
    if merge:
        keep &= (x != prev)
    # stable-compact kept tokens to the front
    pos = torch.where(keep, steps, t)
    order = torch.argsort(pos, dim=1, stable=True)
    compacted = torch.gather(x, 1, order)
    n_keep = keep.sum(dim=1)
    out = torch.where(steps < n_keep[:, None], compacted,
                      torch.full_like(compacted, pad))
    return {"Output": [out.to(torch.int64)],
            "OutputLength": [n_keep.to(torch.int32)[:, None]]}


@register_op("chunk_eval", not_differentiable=True, grad_free=True)
def _chunk_eval(ctx, ins, attrs):
    """reference: chunk_eval_op.h — chunking precision/recall/F1.
    Dense redesign: Inference/Label [b, T] + SeqLength [b]. All four
    reference schemes: tag = type * num_tag + tag_idx with
      IOB   (num_tag=2): 0=B, 1=I
      IOE   (num_tag=2): 0=I, 1=E
      IOBES (num_tag=4): 0=B, 1=I, 2=E, 3=S
      plain (num_tag=1): the tag IS the type."""
    inf = ins["Inference"][0].reshape(
        ins["Inference"][0].shape[0], -1).to(torch.int32)
    lab = ins["Label"][0].reshape(inf.shape).to(torch.int32)
    b, t = inf.shape
    dev = inf.device
    lengths = (ins["SeqLength"][0].reshape(-1).to(torch.int32)
               if "SeqLength" in ins else
               torch.full((b,), t, dtype=torch.int32, device=dev))
    num_types = int(attrs.get("num_chunk_types", 1))
    scheme = attrs.get("chunk_scheme", "IOB")
    num_tag = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}.get(scheme)
    if num_tag is None:
        raise ValueError(f"chunk_eval: unknown chunk_scheme {scheme!r}")
    other = num_types * num_tag  # the O tag

    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]

    def starts(seq):
        ty = seq // num_tag
        tag = seq % num_tag
        in_chunk = seq < other
        prev = torch.cat([torch.full((b, 1), other, dtype=torch.int32,
                                     device=dev), seq[:, :-1]], dim=1)
        prev_ty = prev // num_tag
        prev_tag = prev % num_tag
        prev_in = prev < other
        if scheme == "IOB":
            # starts at B, or at I following O / a different type
            start = (tag == 0) | ((tag == 1)
                                  & (~prev_in | (prev_ty != ty)))
        elif scheme == "IOE":
            # E ends a chunk: the NEXT in-chunk position starts a new one
            prev_closed = prev_in & (prev_tag == 1)
            start = ~prev_in | (prev_ty != ty) | prev_closed
        elif scheme == "IOBES":
            prev_cont = prev_in & (prev_ty == ty) & (prev_tag <= 1)
            start = (tag == 0) | (tag == 3) | ~prev_cont
        else:  # plain: every maximal same-type run
            start = ~prev_in | (prev_ty != ty)
        return (start & in_chunk) & valid, ty

    inf_in = (inf < other) & valid
    lab_in = (lab < other) & valid
    inf_st, inf_ty = starts(inf)
    lab_st, lab_ty = starts(lab)

    # A label chunk [s, e) is matched iff:
    #   (1) inference starts a chunk of the same type exactly at s,
    #   (2) every position in [s, e) is inside an inference chunk of
    #       the same type with no inference chunk boundary inside,
    #   (3) the inference chunk ENDS at e too (no extension past e).
    def nxt(m):
        return torch.cat([m[:, 1:], torch.zeros((b, 1), dtype=torch.bool,
                                                device=dev)], dim=1)

    agree = inf_in & lab_in & (inf_ty == lab_ty) & ~(inf_st & ~lab_st)
    lab_end = lab_in & (~nxt(lab_in) | nxt(lab_st))    # chunk's last pos
    ext_bad = lab_end & nxt(inf_in) & ~nxt(inf_st)     # inf runs past e
    ok_pos = torch.where(lab_in, agree & ~ext_bad, True)

    seg_id = torch.cumsum(lab_st.to(torch.int64), dim=1)  # 1-based
    max_seg = t + 1
    chunk_ok = torch.ones((b, max_seg), dtype=torch.int32, device=dev)
    chunk_ok = chunk_ok.scatter_reduce(
        1, torch.where(lab_in, seg_id, max_seg - 1),
        torch.where(lab_in, ok_pos, True).to(torch.int32), "amin")
    start_ok = lab_st & inf_st & (inf_ty == lab_ty)
    correct = (start_ok & torch.gather(chunk_ok, 1, seg_id).bool()).sum()
    num_inf = inf_st.sum()
    num_lab = lab_st.sum()
    p = correct / torch.clamp(num_inf, min=1)
    r = correct / torch.clamp(num_lab, min=1)
    f1 = 2 * p * r / torch.clamp(p + r, min=1e-10)

    def i64(v):
        return v.to(torch.int64)[None]

    def f32(v):
        return v.to(torch.float32)[None]
    return {"Precision": [f32(p)], "Recall": [f32(r)], "F1-Score": [f32(f1)],
            "NumInferChunks": [i64(num_inf)],
            "NumLabelChunks": [i64(num_lab)],
            "NumCorrectChunks": [i64(correct)]}
