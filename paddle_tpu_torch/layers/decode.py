"""Autoregressive decoding helpers: greedy and beam search.

Port of `paddle_tpu/layers/decode.py`. Reference: the LoD-based
beam_search/beam_search_decode ops (operators/beam_search_op.cc,
beam_search_decode_op.cc) driven by a while_op loop. Here, as in the JAX
package, decoding is a loop over a single-step function with static shapes
(beams are a fixed dimension folded into the batch), finished with the
gather_tree backtrace op. No dynamic LoD structures anywhere.

`greedy_decode` and `beam_search_decode` are host loops: `step_logits(
tokens) -> logits` receives the full padded token prefix [b*beam, t] as a
numpy int64 array and returns next-token logits [b*beam, V], as a torch
tensor on any device or a numpy array; the selection runs in numpy, as
the JAX package's does.

`beam_search_decode_on_device` is an eager loop of max_len steps on the
logits' device that reads nothing back to the host until the loop ends.
The JAX package jits its whole loop once and keeps the executable in a
cache keyed by the step function and the shapes; an eager loop compiles
nothing, so there is nothing to cache.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ["greedy_decode", "beam_search_decode",
           "beam_search_decode_on_device"]


def _host(logits) -> np.ndarray:
    """A step's logits as a numpy array (a torch tensor from any
    device)."""
    if isinstance(logits, torch.Tensor):
        return logits.detach().cpu().numpy()
    return np.asarray(logits)


def _gather_tree(ids, parents, device):
    """The registered gather_tree lowering (the one backtrace both
    beam-search variants share)."""
    from ..framework.registry import LowerContext, get_op_def
    return get_op_def("gather_tree").lower(
        LowerContext(device=device), {"Ids": [ids], "Parents": [parents]},
        {})["Out"][0]


def greedy_decode(step_logits: Callable[[np.ndarray], object],
                  batch_size: int, bos_id: int, eos_id: int,
                  max_len: int) -> np.ndarray:
    """Greedy argmax decoding; returns [b, max_len] token ids (eos-padded
    after each row finishes)."""
    tokens = np.full((batch_size, max_len + 1), eos_id, np.int64)
    tokens[:, 0] = bos_id
    done = np.zeros(batch_size, bool)
    for t in range(max_len):
        logits = _host(step_logits(tokens[:, : t + 1]))
        nxt = np.argmax(logits, axis=-1).astype(np.int64)
        nxt = np.where(done, eos_id, nxt)
        tokens[:, t + 1] = nxt
        done |= nxt == eos_id
        if done.all():
            break
    return tokens[:, 1:]


def beam_search_decode(step_logits: Callable[[np.ndarray], object],
                       batch_size: int, beam_size: int, bos_id: int,
                       eos_id: int, max_len: int,
                       length_penalty: float = 0.0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Standard beam search. step_logits sees [b*beam, t] prefixes and
    returns [b*beam, V] next-token logits. Returns (sequences [b, beam,
    max_len], scores [b, beam]) best-first, reconstructed with the
    gather_tree backtrace (ids/parents stacked per step like the
    reference's beam-search decode pass). A tie between candidates goes to
    the lower flat index (beam-major), as `jax.lax.top_k` breaks it."""
    def log_softmax(x, axis=-1):
        m = x.max(axis=axis, keepdims=True)
        z = x - m
        return z - np.log(np.exp(z).sum(axis=axis, keepdims=True))

    b, k = batch_size, beam_size
    tokens = np.full((b * k, max_len + 1), eos_id, np.int64)
    tokens[:, 0] = bos_id
    scores = np.full((b, k), -1e9, np.float32)
    scores[:, 0] = 0.0                      # only beam 0 is live at t=0
    finished = np.zeros((b, k), bool)
    ids_hist, parents_hist = [], []

    for t in range(max_len):
        logits = _host(step_logits(tokens[:, : t + 1]))
        logp = log_softmax(logits.astype(np.float64), axis=-1)
        v = logp.shape[-1]
        logp = logp.reshape(b, k, v)
        # finished beams only extend with eos at no cost
        pad_mask = np.full((v,), -1e9)
        pad_mask[eos_id] = 0.0
        logp = np.where(finished[:, :, None], pad_mask[None, None, :], logp)
        total = scores[:, :, None] + logp      # [b, k, v]
        flat = total.reshape(b, k * v)
        top = np.argsort(-flat, axis=-1, kind="stable")[:, :k]
        scores = np.take_along_axis(flat, top, axis=-1).astype(np.float32)
        parents = (top // v).astype(np.int64)          # [b, k]
        ids = (top % v).astype(np.int64)               # [b, k]
        ids_hist.append(ids)
        parents_hist.append(parents)
        # reorder token prefixes by parent beam
        tokens = tokens.reshape(b, k, -1)
        tokens = np.take_along_axis(tokens, parents[:, :, None], axis=1)
        tokens = tokens.reshape(b * k, -1)
        tokens[:, t + 1] = ids.reshape(-1)
        finished = np.take_along_axis(finished, parents, axis=1) | (
            ids == eos_id)
        if finished.all():
            break

    seqs = _gather_tree(torch.from_numpy(np.stack(ids_hist)),
                        torch.from_numpy(np.stack(parents_hist)),
                        "cpu").numpy()                 # [T, b, k]
    seqs = np.transpose(seqs, (1, 2, 0))               # [b, k, T]
    if seqs.shape[-1] < max_len:
        pad = np.full((b, k, max_len - seqs.shape[-1]), eos_id, np.int64)
        seqs = np.concatenate([seqs, pad], axis=-1)
    if length_penalty > 0:
        lens = (seqs != eos_id).sum(-1).clip(min=1)
        scores = scores / (lens.astype(np.float32) ** length_penalty)
        order = np.argsort(-scores, axis=-1, kind="stable")
        seqs = np.take_along_axis(seqs, order[:, :, None], axis=1)
        scores = np.take_along_axis(scores, order, axis=-1)
    return seqs, scores


def beam_search_decode_on_device(step_logits, batch_size: int,
                                 beam_size: int, bos_id: int, eos_id: int,
                                 max_len: int,
                                 length_penalty: float = 0.0,
                                 init_state=None, reorder_state=None,
                                 device=None):
    """ON-DEVICE beam search: max_len steps, each a step call and a few
    tensor ops on the device, then the gather_tree backtrace there; the
    loop reads nothing back to the host (the JAX package's variant is one
    jitted lax.fori_loop).

    step_logits is fn(tokens [b*k, max_len+1] int64 on the device, t: int)
    -> [b*k, V] next-token logits for the prefix tokens[:, :t+1] (static
    padded shape; use `t` for masking).

    CACHED (incremental-state) steps: pass `init_state` (a tensor or any
    pytree of tensors, e.g. a KV cache) and the step signature becomes
    fn(tokens, t, state) -> (logits, new_state). After each step's top-k
    the surviving beams are a parent-permutation of the previous ones, so
    the state must be reordered too: `reorder_state(state, parent [b, k]
    int64) -> state` does that (required with init_state unless every
    state leaf has leading dim b*k, which is reordered automatically).

    `device`: where the loop runs; by default the device of init_state's
    first tensor, else CUDA (no card raises: it never runs on the CPU
    unless asked). The candidates of a step are ranked by a stable
    descending sort of the flattened (b, k*V) scores, so a tie goes to
    the lower index as `jax.lax.top_k` breaks it; `torch.topk` on CUDA
    promises no order among ties.

    Returns (sequences [b, beam, max_len], scores [b, beam]) as numpy
    arrays, best-first, matching the host-loop beam_search_decode.
    """
    b, k = batch_size, beam_size
    L = max_len
    neg_inf = -1e9
    stateful = init_state is not None
    leaves = [x for x in pytree.tree_leaves(init_state)
              if isinstance(x, torch.Tensor)] if stateful else []

    if stateful and reorder_state is None:
        # the default reorder gathers leaf[parent] along axis 0; a
        # wrong-layout state (e.g. a KV cache with batch at axis 2) would
        # decode garbage or fail mid-loop — validate up front
        for leaf in pytree.tree_leaves(init_state):
            if tuple(leaf.shape[:1]) != (b * k,):
                raise ValueError(
                    f"init_state leaf has shape {tuple(leaf.shape)}; the "
                    f"default reorder needs leading dim b*beam={b * k}. "
                    "Pass reorder_state= for other layouts (e.g. a KV "
                    "cache with its batch axis elsewhere)")
    if device is None:
        if leaves:
            device = leaves[0].device
        elif torch.cuda.is_available():
            device = torch.device("cuda")
        else:
            raise RuntimeError(
                "beam_search_decode_on_device runs on the CUDA card by "
                "default and none is available; pass device='cpu' to run "
                "on the CPU")
    device = torch.device(device)

    def _default_reorder(state, parent):
        # every leaf (b*k, ...): gather rows by parent beam
        flat = (parent + torch.arange(b, device=device)[:, None] * k
                ).reshape(-1)
        return pytree.tree_map(lambda a: a[flat], state)

    do_reorder = reorder_state if reorder_state is not None \
        else _default_reorder

    tokens = torch.full((b * k, L + 1), eos_id, dtype=torch.int64,
                        device=device)
    tokens[:, 0] = bos_id
    # only beam 0 live initially (identical prefixes must not multiply
    # through top-k)
    scores = torch.full((b, k), neg_inf, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    ids_stack = torch.zeros((L, b, k), dtype=torch.int64, device=device)
    par_stack = torch.zeros((L, b, k), dtype=torch.int64, device=device)
    finished = torch.zeros((b, k), dtype=torch.bool, device=device)
    state = init_state
    only_eos = None

    for t in range(L):
        if stateful:
            logits, state = step_logits(tokens, t, state)
        else:
            logits = step_logits(tokens, t)          # [b*k, V]
        v = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, v)
        if only_eos is None:
            # built with where, not an indexed store: writing a python
            # scalar through an index copies it from the host
            only_eos = torch.where(
                torch.arange(v, device=device) == eos_id, 0.0, neg_inf)
        # finished beams only extend with eos at zero cost
        logp = torch.where(finished[:, :, None], only_eos, logp)
        total = scores[:, :, None] + logp            # [b, k, v]
        flat = total.reshape(b, k * v)
        top_s, top_i = torch.sort(flat, dim=-1, descending=True,
                                  stable=True)
        top_s, top_i = top_s[:, :k], top_i[:, :k]
        parent = top_i // v
        tok = top_i % v
        # reorder token prefixes to the selected parents
        tokens = torch.gather(tokens.reshape(b, k, L + 1), 1,
                              parent[:, :, None].expand(b, k, L + 1)
                              ).reshape(b * k, L + 1)
        tokens[:, t + 1] = tok.reshape(-1)
        finished = torch.gather(finished, 1, parent) | (tok == eos_id)
        ids_stack[t] = tok
        par_stack[t] = parent
        scores = top_s
        if stateful:
            state = do_reorder(state, parent)

    seqs = _gather_tree(ids_stack, par_stack, device).permute(1, 2, 0)
    if length_penalty > 0.0:
        # same formula as the host-loop variant above: plain len**p over
        # non-eos tokens (clipped at 1)
        lengths = torch.clamp((seqs != eos_id).sum(-1), min=1).float()
        scores = scores / (lengths ** length_penalty)
    order = torch.argsort(-scores, dim=1, stable=True)
    seqs = torch.gather(seqs, 1, order[:, :, None].expand_as(seqs))
    scores = torch.gather(scores, 1, order)
    return seqs.cpu().numpy(), scores.cpu().numpy()
