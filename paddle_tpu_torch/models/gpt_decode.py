"""KV-cache autoregressive decoding for the GPT family.

Port of `paddle_tpu/models/gpt_decode.py`: the dense half (a prefill pass
fills a KV cache of shape (layers, 2, b, heads, max_len, head_dim), a
decode step consumes one token + the cache), the PAGED half the serving
engine runs (K/V rows in a block arena `(layers, 2, num_blocks, heads,
block_size, head_dim)` indirected through per-sequence page tables), and
the serving sampler's counter-based threefry2x32, which matches the JAX
function bit for bit.

Everything is built from torch ops on the parameters' device; the JAX
module reaches no Pallas kernel (its attention is einsums), so neither
does this one. Forward math mirrors the JAX module exactly (pre-LN,
separate q/k/v, tanh gelu, tied wte head, f32 LN statistics, masks at
-1e30 with the row max subtracted before exp).

Where the JAX code leans on XLA's index rules (a gather clamps an
out-of-range index), the port clamps explicitly: the page index of a
decode slot (`_page_of`), the page index of a padded prefill row, and
the position-table row of a pad or frozen position. A scatter whose
target is not a real row is redirected to the scratch block 0. The
arena is written in place (`index_put_`), never rebuilt: the JAX
engine donates it.

The slot-slab functions (`gpt_decode_step_slots`,
`gpt_decode_verify_slots`, `gpt_decode_chunk_slots`) run the same
per-slot math over a contiguous cache `(layers, 2, S, heads, max_len,
hd)`; no engine family calls them. Speculative decoding drafts from a
per-slot hashed trigram table (`_ngram_hash`, `spec_ngram_seed`),
scores every draft in one multi-position verify pass
(`gpt_decode_verify_slots`, `gpt_decode_verify_pages`) and commits the
matched run in-graph (`_spec_step`, shared by both chunk loops). Where
XLA's scatter drops a write past the slab's end, the slab writes here
keep the row's old value; where a scatter names one table column twice,
XLA's last write wins, and the port makes that rule explicit on every
device (writes in order, one column a row at a time, or the last
position's value resolved by a max over positions).

Quantized serving: `quantize_params` turns the six matmul weights of
every block into per-output-channel abs-max int8 with f32 scales, and
`_dense` runs (x @ w_q) * w_s; an int8 arena is the pair (int8 data,
f32 scale plane (layers, 2, num_blocks, heads, block_size)), every K/V
row quantized per (row, head) at its scatter (`_kv_write`, data and
scale through the same redirected block index) and dequantized at its
page gather (`_kv_gather`), the only dequant site. The codes and scales
are the JAX functions' bit for bit: the scale factor is a true division
(127.0 / abs-max, never a multiply by a reciprocal), then a product,
round half to even and a clamp to +-127.

Multi-tenant LoRA adapters: a pool {proj: {"a": (N, L, in, rank),
"b": (N, L, rank, out)}} over ADAPTER_PROJECTIONS, row 0 the all-zero
identity. The paged functions gather each slot's A/B rows by its pool
row and add (x @ A) @ B in f32 to every projection (`_dense_a`); rows
on the identity take the base output through torch.where, never an add
of zeros. Without a pool the paged functions run exactly the
adapterless ops.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["collect_gpt_params", "quantize_params", "gpt_forward_logits",
           "gpt_prefill",
           "gpt_prefill_padded", "gpt_decode_step",
           "gpt_decode_step_slots", "gpt_decode_verify_slots",
           "gpt_decode_chunk_slots", "gpt_prefill_pages",
           "gpt_prefill_chunk_pages", "gpt_decode_step_pages",
           "gpt_decode_verify_pages", "gpt_decode_chunk_pages",
           "spec_ngram_seed", "_ngram_hash", "_spec_step",
           "gpt_generate",
           "QUANTIZED_KV_KERNELS", "ADAPTER_KERNELS",
           "ADAPTER_PROJECTIONS", "threefry2x32", "sample_key",
           "sample_split", "sample_gumbel"]

# The paged functions whose KV dequant path exists: a quantized arena
# may only flow through functions named here (the engine's validation
# reads this).
QUANTIZED_KV_KERNELS = ("gpt_prefill_pages", "gpt_prefill_chunk_pages",
                        "gpt_decode_step_pages",
                        "gpt_decode_chunk_pages",
                        "gpt_decode_verify_pages")

# The paged functions whose per-slot LoRA gather-matmul path exists
# (likewise read by the engine's validation).
ADAPTER_KERNELS = ("gpt_prefill_pages", "gpt_prefill_chunk_pages",
                   "gpt_decode_step_pages",
                   "gpt_decode_chunk_pages",
                   "gpt_decode_verify_pages")

# projections the low-rank adapter path covers
ADAPTER_PROJECTIONS = ("q", "k", "v", "out", "mlp1", "mlp2")

# the masking value of every attention mask here: finite, so a fully
# masked row (a frozen slot reading scratch) stays finite
_MASKED = -1e30


def _ln_names(name):
    return f"{name}.scale", f"{name}.bias"


def collect_gpt_params(scope, cfg, prefix="gpt", dtype=None):
    """Pull the GPT parameter tree out of an executor scope (the vars
    models/gpt.py's programs create). The tensors stay where the scope
    holds them (the engine runs on their device); dtype=torch.bfloat16
    casts the copy used for decoding (the scope's tensors untouched)."""

    def get(name):
        v = scope.find_var(name)
        if v is None:
            raise KeyError(f"param {name!r} not found in scope")
        return v.to(dtype) if dtype is not None else v

    def ln(name):
        s, b = _ln_names(name)
        return {"g": get(s), "b": get(b)}

    p = {"wte": get(f"{prefix}/wte"), "wpe": get(f"{prefix}/wpe"),
         "lnf": ln(f"{prefix}/lnf"), "blocks": []}
    for i in range(cfg.layers):
        pre = f"{prefix}/l{i}"
        blk = {"ln1": ln(f"{pre}/ln1"), "ln2": ln(f"{pre}/ln2")}
        for nm in ("q", "k", "v", "out", "mlp1", "mlp2"):
            blk[nm] = {"w": get(f"{pre}/{nm}.w"), "b": get(f"{pre}/{nm}.b")}
        p["blocks"].append(blk)
    return p


def quantize_params(params, cfg):
    """Weight-only int8 quantization of the decode parameter tree: the
    q/k/v/out/mlp1/mlp2 weights become per-OUTPUT-channel abs-max int8
    {"w_q": int8 (in, out), "w_s": f32 (out,), "b": ...}; embeddings,
    layer norms and biases are the same tensors. The codes and scales
    equal the JAX function's bit for bit: 127.0 / abs-max by true
    division, times the weight, rounded half to even, clamped to
    +-127; the scale is abs-max / 127. Deterministic in the weights."""

    def q(w):
        w32 = w.float()
        s = w32.abs().amax(0)                       # (out,)
        safe = torch.where(s > 0, s, torch.ones_like(s))
        wq = torch.round(w32 * (torch.full_like(safe, 127.0) / safe))
        return (wq.clamp(-127, 127).to(torch.int8),
                s / torch.full_like(s, 127.0))

    out = {"wte": params["wte"], "wpe": params["wpe"],
           "lnf": params["lnf"], "blocks": []}
    for blk in params["blocks"]:
        nb = {"ln1": blk["ln1"], "ln2": blk["ln2"]}
        for nm in ADAPTER_PROJECTIONS:
            wq, ws = q(blk[nm]["w"])
            nb[nm] = {"w_q": wq, "w_s": ws, "b": blk[nm]["b"]}
        out["blocks"].append(nb)
    return out


def param_tensors(params):
    """Every tensor of a parameter tree, in a fixed order (a quantized
    projection's w_q and w_s in place of its w)."""
    out = [params["wte"], params["wpe"], params["lnf"]["g"],
           params["lnf"]["b"]]
    for blk in params["blocks"]:
        for nm in ("ln1", "ln2"):
            out += [blk[nm]["g"], blk[nm]["b"]]
        for nm in ADAPTER_PROJECTIONS:
            p = blk[nm]
            out += ([p["w_q"], p["w_s"]] if "w_q" in p else [p["w"]])
            out.append(p["b"])
    return out


def compute_dtype(params):
    """The activation dtype: bfloat16 for a bf16 checkpoint, else f32."""
    return torch.bfloat16 if params["wte"].dtype == torch.bfloat16 \
        else torch.float32


def _ln(x, p, eps=1e-5):
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    v = ((xf - m) ** 2).mean(-1, keepdim=True)
    y = (xf - m) * torch.rsqrt(v + eps)
    return (y * p["g"].float() + p["b"].float()).to(x.dtype)


def _dense(x, p):
    if "w_q" in p:
        # weight-only int8: (x @ w_q) * s == x @ (w_q * s) for
        # per-output-channel scales
        y = (x @ p["w_q"].to(x.dtype)) * p["w_s"].to(x.dtype)
        return y + p["b"].to(x.dtype)
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def _lora_layer(adapters, adapter_ids, li, live):
    """Per-layer gathered LoRA operands: {proj: (A, B, live) | None}.
    adapter_ids is an (S,) tensor of pool rows (per-slot decode) or an
    int row (single-sequence prefill); `live` is the (adapter_ids != 0)
    mask over the slots, or None where every row is live. No pool, or
    the prefill of a sequence on the identity row 0, gives None for
    every projection: the base output exactly."""
    if adapters is None or (isinstance(adapter_ids, int)
                            and adapter_ids == 0):
        return dict.fromkeys(ADAPTER_PROJECTIONS)
    return {nm: (adapters[nm]["a"][adapter_ids, li],
                 adapters[nm]["b"][adapter_ids, li], live)
            for nm in ADAPTER_PROJECTIONS}


def _dense_a(x, p, lora):
    """_dense plus the gathered low-rank delta (x @ A) @ B in f32; rows
    whose `live` is False take the base output through torch.where on
    the whole row (an add of an all-zero delta could still flip -0.0).
    lora=None is exactly _dense."""
    y = _dense(x, p)
    if lora is None:
        return y
    a, b, live = lora
    # (B, in) @ (in, r) for a prefill row; (S, n, in) @ (S, in, r) a slot
    d = torch.matmul(torch.matmul(x.float(), a), b)
    out = y + d.to(y.dtype)
    return out if live is None else torch.where(live, out, y)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def _split_heads(x, heads):
    b, s, h = x.shape
    return x.reshape(b, s, heads, h // heads)


def _softmax_rows(scores, dtype):
    """exp(s - max) / sum over the last axis, as the JAX code spells it
    (not torch.softmax: the same rounding steps)."""
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    return (probs / probs.sum(-1, keepdim=True)).to(dtype)


def _mlp_block(x, blk, la=None):
    """The MLP half of a block; `la` the layer's LoRA operands from
    _lora_layer (None, or None for every projection: no adapter)."""
    la = la or {}
    h = _ln(x, blk["ln2"])
    return x + _dense_a(_gelu_tanh(_dense_a(h, blk["mlp1"],
                                            la.get("mlp1"))),
                        blk["mlp2"], la.get("mlp2"))


def _positions(params, pos):
    """wpe rows at `pos`, clamped to the table as XLA's gather clamps
    (only pad and frozen positions ever reach past it)."""
    return params["wpe"][pos.clamp(0, params["wpe"].shape[0] - 1)]


def gpt_forward_logits(params, cfg, tokens):
    """Full-prefix forward (no cache): tokens (b, s) -> logits (b, s, V).
    The no-cache reference the cached paths are held to."""
    tokens = torch.as_tensor(tokens, device=params["wte"].device).long()
    b, s = tokens.shape
    dtype = compute_dtype(params)
    x = (params["wte"][tokens] + params["wpe"][:s]).to(dtype)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                 device=x.device))
    for blk in params["blocks"]:
        h = _ln(x, blk["ln1"])
        q = _split_heads(_dense(h, blk["q"]), cfg.heads)
        k = _split_heads(_dense(h, blk["k"]), cfg.heads)
        v = _split_heads(_dense(h, blk["v"]), cfg.heads)
        hd = q.shape[-1]
        scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
        scores = scores / np.sqrt(hd)
        scores = torch.where(mask, scores, _MASKED)
        probs = _softmax_rows(scores, dtype)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, s, -1)
        x = x + _dense(ctx, blk["out"])
        x = _mlp_block(x, blk)
    x = _ln(x, params["lnf"])
    return (x @ params["wte"].T.to(x.dtype)).float()


def _prefill_blocks(params, cfg, tokens, max_len):
    """Shared prefill body: run the whole (possibly padded) prompt
    through every block, filling the KV cache. Returns (hidden states
    (b, P, h) BEFORE the final LN, cache)."""
    b, p_len = tokens.shape
    heads, hd = cfg.heads, cfg.hidden // cfg.heads
    dtype = compute_dtype(params)
    dev = params["wte"].device
    x = (params["wte"][tokens] + params["wpe"][:p_len]).to(dtype)
    mask = torch.tril(torch.ones((p_len, p_len), dtype=torch.bool,
                                 device=dev))
    cache = torch.zeros((cfg.layers, 2, b, heads, max_len, hd),
                        dtype=dtype, device=dev)
    for li, blk in enumerate(params["blocks"]):
        h = _ln(x, blk["ln1"])
        q = _split_heads(_dense(h, blk["q"]), heads)
        k = _split_heads(_dense(h, blk["k"]), heads)
        v = _split_heads(_dense(h, blk["v"]), heads)
        # cache layout (.., heads, seq, hd): seq-major per head
        cache[li, 0, :, :, :p_len] = k.transpose(1, 2)
        cache[li, 1, :, :, :p_len] = v.transpose(1, 2)
        scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
        scores = torch.where(mask, scores / np.sqrt(hd), _MASKED)
        probs = _softmax_rows(scores, dtype)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(
            b, p_len, -1)
        x = x + _dense(ctx, blk["out"])
        x = _mlp_block(x, blk)
    return x, cache


def _head_logits(params, last):
    """Final LN + tied-wte head over a (b, 1, h) slice -> (b, V) f32."""
    last = _ln(last, params["lnf"])
    logits = (last @ params["wte"].T.to(last.dtype))[:, 0]
    return logits.float()


def gpt_prefill(params, cfg, tokens, max_len):
    """Run the prompt once, filling the KV cache.

    tokens: (b, P) ints. Returns (logits_last (b, V) f32,
    cache (layers, 2, b, heads, max_len, head_dim))."""
    tokens = torch.as_tensor(tokens, device=params["wte"].device).long()
    x, cache = _prefill_blocks(params, cfg, tokens, max_len)
    return _head_logits(params, x[:, -1:]), cache


def gpt_prefill_padded(params, cfg, tokens, real_len, max_len):
    """Prefill a RIGHT-PADDED prompt: tokens (b, L_bucket) padded past
    the real prompt, real_len (b,) actual lengths. Returns (logits at
    position real_len-1 (b, V) f32, cache) with K/V rows [0, L_bucket)
    written. Pad rows are overwritten by the decode steps at those
    positions before any step's [0, t] window reaches them."""
    dev = params["wte"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    real_len = torch.as_tensor(real_len, device=dev).long()
    x, cache = _prefill_blocks(params, cfg, tokens, max_len)
    b = tokens.shape[0]
    last = x[torch.arange(b, device=dev), real_len - 1][:, None]
    return _head_logits(params, last), cache


def gpt_decode_step(params, cfg, token, cache, t):
    """One cached decode step. token: (b,) ints, t: the ABSOLUTE position
    being computed (a Python int). Writes row t of `cache` in place and
    returns (logits (b, V) f32, cache). Attention reads keys [0, t]."""
    heads = cfg.heads
    hd = cfg.hidden // cfg.heads
    max_len = cache.shape[4]
    dev = cache.device
    token = torch.as_tensor(token, device=dev).long()
    b = token.shape[0]
    t = int(t)
    dtype = cache.dtype
    x = (params["wte"][token] + params["wpe"][t]).to(dtype)[:, None]
    pos_mask = torch.arange(max_len, device=dev) <= t
    for li, blk in enumerate(params["blocks"]):
        h = _ln(x, blk["ln1"])
        q = _dense(h, blk["q"]).reshape(b, heads, 1, hd)
        k = _dense(h, blk["k"]).reshape(b, heads, 1, hd)
        v = _dense(h, blk["v"]).reshape(b, heads, 1, hd)
        cache[li, 0, :, :, t:t + 1] = k
        cache[li, 1, :, :, t:t + 1] = v
        K, V = cache[li, 0], cache[li, 1]          # (b, n, S, hd)
        scores = torch.einsum("bnqd,bnkd->bnqk", q.float(), K.float())
        scores = torch.where(pos_mask, scores / np.sqrt(hd), _MASKED)
        probs = _softmax_rows(scores, dtype)
        ctx = torch.einsum("bnqk,bnkd->bnqd", probs, V)
        ctx = ctx.transpose(1, 2).reshape(b, 1, -1)
        x = x + _dense(ctx, blk["out"])
        x = _mlp_block(x, blk)
    return _head_logits(params, x), cache


# -- slot slab ----------------------------------------------------------------

def _slab_write(plane, rows, pos, val, max_len):
    """One K or V column write into a slab plane (S, heads, max_len, hd),
    in place: row pos[s] of slot s takes val[s] (heads, hd). A position
    past the slab keeps its row's old value, as XLA's scatter drops it
    (the clamped index and the kept value make every device agree)."""
    pc = pos.clamp(max=max_len - 1)
    keep = plane[rows, :, pc]
    plane[rows, :, pc] = torch.where((pos < max_len)[:, None, None], val,
                                     keep)


def _slab_pass(params, cfg, toks, cache, ts):
    """Shared body of gpt_decode_step_slots / gpt_decode_verify_slots:
    toks (S, D) at positions ts..ts+D-1 a slot; writes the D K/V rows of
    every slot in order (one column a time, so no write names a row
    twice) before each layer's attention. Returns (logits (S, D, V) f32,
    cache)."""
    heads = cfg.heads
    hd = cfg.hidden // cfg.heads
    max_len = cache.shape[4]
    dev = cache.device
    s_dim, D = toks.shape
    dtype = cache.dtype
    rows = torch.arange(s_dim, device=dev)
    pos = ts[:, None] + torch.arange(D, device=dev)[None, :]     # (S, D)
    x = (params["wte"][toks] + _positions(params, pos)).to(dtype)
    pos_mask = torch.arange(max_len, device=dev)[None, None, :] \
        <= pos[:, :, None]
    for li, blk in enumerate(params["blocks"]):
        h = _ln(x, blk["ln1"])
        q = _dense(h, blk["q"]).reshape(s_dim, D, heads, hd)
        k = _dense(h, blk["k"]).reshape(s_dim, D, heads, hd)
        v = _dense(h, blk["v"]).reshape(s_dim, D, heads, hd)
        for j in range(D):
            _slab_write(cache[li, 0], rows, pos[:, j], k[:, j], max_len)
            _slab_write(cache[li, 1], rows, pos[:, j], v[:, j], max_len)
        K, V = cache[li, 0], cache[li, 1]          # (S, n, L, hd)
        scores = torch.einsum("bqnd,bnkd->bnqk", q.float(), K.float())
        scores = torch.where(pos_mask[:, None], scores / np.sqrt(hd),
                             _MASKED)
        probs = _softmax_rows(scores, dtype)
        ctx = torch.einsum("bnqk,bnkd->bqnd", probs, V).reshape(
            s_dim, D, -1)
        x = x + _dense(ctx, blk["out"])
        x = _mlp_block(x, blk)
    x = _ln(x, params["lnf"])
    return (x @ params["wte"].T.to(x.dtype)).float(), cache


def gpt_decode_step_slots(params, cfg, tokens, cache, ts):
    """One cached decode step over the SLOT dimension: every slot
    advances at its own absolute position. tokens/ts: (S,) ints, cache:
    (layers, 2, S, heads, max_len, hd), written in place (row ts[s] of
    slot s). Returns (logits (S, V) f32, cache). Retired or free slots
    may keep stepping: their writes land at a stale position the next
    admission's prefill overwrites before anything reads it."""
    dev = cache.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    ts = torch.as_tensor(ts, device=dev).long()
    logits, cache = _slab_pass(params, cfg, tokens[:, None], cache, ts)
    return logits[:, 0], cache


def gpt_decode_verify_slots(params, cfg, toks, cache, ts):
    """Multi-position decode step over the slot dimension, the
    speculative VERIFY pass: toks (S, D) candidate tokens at positions
    ts..ts+D-1 a slot (column 0 the committed current token, columns 1..
    the drafts). One pass writes all D K/V rows and returns logits for
    every position, (S, D, V) f32. The query at offset j attends [0,
    ts+j]; rows ts..ts+j are written this pass before the layer reads
    them, so a previous pass's rejected rows are always rewritten first.
    Writes past max_len are dropped (the row keeps its value) and their
    wpe rows clamped; the budget mask never commits a token there. D = 1
    is gpt_decode_step_slots row for row."""
    dev = cache.device
    toks = torch.as_tensor(toks, device=dev).long()
    ts = torch.as_tensor(ts, device=dev).long()
    return _slab_pass(params, cfg, toks, cache, ts)


def _chunk_loop(step, sample_fn, tokens, pool, ts, keys, temps, done,
                remaining, eos_ids, chunk):
    """The non-speculative chunk loop of both pools: `chunk` iterations
    of step(tok, pool, ts, done) -> (logits, pool), the whole-pool
    sampler and the EOS/budget masks, all on the device."""
    rows = []
    tok = tokens
    for _ in range(int(chunk)):
        logits, pool = step(tok, pool, ts, done)
        nxt, keys = sample_fn(keys, logits, temps)
        emit = torch.where(done, tok, nxt)
        remaining = torch.where(done, remaining, remaining - 1)
        ndone = done | (emit == eos_ids) | (remaining <= 0)
        ts = torch.where(done, ts, ts + 1)
        done = ndone
        tok = emit
        rows.append(emit)
    return torch.stack(rows), tok, pool, ts, keys, done, remaining


def _spec_loop(verify, sample_fn, temps, eos_ids, speculate_k, chunk,
               carry):
    """The speculative chunk loop of both pools: `chunk` _spec_step
    passes. Returns (block (chunk, k+1, S), counts (chunk, S), carry')."""
    blocks, counts = [], []
    for _ in range(int(chunk)):
        carry, (out, cnt) = _spec_step(verify, sample_fn, temps, eos_ids,
                                       speculate_k, carry)
        blocks.append(out)
        counts.append(cnt)
    return torch.stack(blocks), torch.stack(counts), carry


def gpt_decode_chunk_slots(params, cfg, tokens, cache, ts, keys, temps,
                           done, remaining, eos_ids, chunk,
                           sample_fn=None, speculate_k=0,
                           spec_state=None):
    """`chunk` iterations of gpt_decode_step_slots + per-slot sampling +
    EOS/budget masking over the slab cache, queued back to back on the
    cache's device (the JAX function's lax.scan; nothing reads a value
    back to the host). Carry and masks as in gpt_decode_chunk_pages,
    except that a frozen slot's ride-along step still writes row ts of
    its OWN slab slot (the next admission's prefill overwrites it).

    Returns (block (chunk, S) int64, tokens, cache, ts, keys, done,
    remaining).

    SPECULATIVE MODE (speculate_k > 0): each iteration is one draft ->
    verify -> accept pass (_spec_step) over spec_state = (prev (S,)
    previous committed token, table (S, T+1) trigram table, written in
    place), one gpt_decode_verify_slots pass scoring every draft. Returns
    (block (chunk, k+1, S), counts (chunk, S), tokens, cache, ts, keys,
    done, remaining, (prev, table)): block[i, :counts[i, s], s] are slot
    s's committed tokens of pass i."""
    if sample_fn is None:
        sample_fn = greedy_sample
    dev = cache.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    ts = torch.as_tensor(ts, device=dev).long()
    if int(speculate_k) > 0:
        prev, table = spec_state

        def verify(inputs, cache, ts, done):
            return gpt_decode_verify_slots(params, cfg, inputs, cache, ts)

        block, counts, carry = _spec_loop(
            verify, sample_fn, temps, eos_ids, speculate_k, chunk,
            (tokens, cache, ts, keys, done, remaining, prev, table))
        tokens, cache, ts, keys, done, remaining, prev, table = carry
        return (block, counts, tokens, cache, ts, keys, done, remaining,
                (prev, table))

    def step(tok, cache, ts, done):
        return gpt_decode_step_slots(params, cfg, tok, cache, ts)

    return _chunk_loop(step, sample_fn, tokens, cache, ts, keys, temps,
                       done, remaining, eos_ids, chunk)


# -- paged pool ---------------------------------------------------------------

def _gather_pages(plane, pages):
    """Assemble K or V matrices from one block-arena plane.

    plane: (num_blocks, heads, block_size, hd) — arena[layer, 0|1].
    pages: (..., P) page table. Returns (..., heads, P*block_size, hd):
    the blocks in logical order, so row t is the K/V of absolute
    position t wherever block t // block_size lives. Entries past a
    sequence's allocated tail point at the scratch block; the causal
    mask keeps attention from reading those rows."""
    g = plane[pages]                      # (..., P, heads, bs, hd)
    g = g.transpose(-4, -3)               # (..., heads, P, bs, hd)
    return g.reshape(*g.shape[:-3], g.shape[-3] * g.shape[-2],
                     g.shape[-1])


# -- quantized block arena ----------------------------------------------------
#
# A quantized arena is the pair (data, scales): data the usual (layers, 2,
# num_blocks, heads, block_size, hd) in int8, scales the f32 plane
# (layers, 2, num_blocks, heads, block_size), one abs-max scale per written
# K/V row per head. Both are written in place through the same redirected
# block index, so the scratch discipline covers both: a frozen slot's
# write dirties scratch data AND scratch scales, never a reallocated
# block's. Where several frozen slots write one scratch row, the data and
# the scale may come from different slots; scratch is never read
# unmasked by a live slot, so that row is never used.

def _arena_parts(arena):
    """(data, scales) of a paged arena; scales is None for the
    full-precision (bare tensor) form."""
    if isinstance(arena, tuple):
        return arena
    return arena, None


def _arena_compute_dtype(params, data, scales):
    """The activation dtype a paged function runs in: the arena's for a
    full-precision arena, the params' wte-derived one for a quantized
    arena (int8 is storage, never math)."""
    if scales is None:
        return data.dtype
    return compute_dtype(params)


def _quantize_rows(val):
    """Per-(row, head) abs-max int8: val (..., heads, hd) -> (q int8 of
    the same shape, scale f32 (..., heads)), bit for bit the JAX
    function's (true division, round half to even, clamp to +-127). A
    zero row quantizes to zeros with scale 0."""
    v32 = val.float()
    a = v32.abs().amax(-1)                           # (..., heads)
    safe = torch.where(a > 0, a, torch.ones_like(a))
    q = torch.round(v32 * (torch.full_like(safe, 127.0) / safe)[..., None])
    return (q.clamp(-127, 127).to(torch.int8),
            a / torch.full_like(a, 127.0))


def _kv_write(arena, li, j, wblk, woff, val):
    """One K/V scatter (j = 0 for K, 1 for V) into the arena, in place:
    row woff[i] of block wblk[i] takes val[i] (heads, hd). On a
    quantized arena the row is quantized at the scatter and its scale
    lands in the scale plane through the same block index."""
    data, scales = _arena_parts(arena)
    if scales is None:
        data[li, j][wblk, :, woff] = val     # a view: lands in the arena
        return
    q, s = _quantize_rows(val)
    data[li, j][wblk, :, woff] = q
    scales[li, j][wblk, :, woff] = s


def _kv_gather(arena, li, j, pages, dtype):
    """Page-gather one K or V matrix (..., heads, P*bs, hd); on a
    quantized arena dequantized right there (int8 * its scale-plane
    entry, in `dtype`), the only dequant site."""
    data, scales = _arena_parts(arena)
    k = _gather_pages(data[li, j], pages)
    if scales is None:
        return k
    g = scales[li, j][pages]              # (..., P, heads, bs)
    g = g.transpose(-3, -2)               # (..., heads, P, bs)
    s = g.reshape(*g.shape[:-2], g.shape[-2] * g.shape[-1])
    return k.to(dtype) * s[..., None].to(dtype)


def gpt_prefill_pages(params, cfg, tokens, pfx_len, real_len, arena,
                      pages, adapters=None, adapter_id=None):
    """Paged prefill of ONE sequence's prompt SUFFIX into its arena
    blocks, attending over an already-cached prefix through the page
    row.

    tokens: (1, B) suffix, right-padded to a shape bucket. pfx_len: how
    many leading prompt positions are already resident (prefix-cache
    hits, a multiple of the block size; 0 = cold prompt). real_len: the
    real suffix length, >= 1. arena: (layers, 2, num_blocks, heads,
    block_size, hd), or the (int8 data, f32 scales) pair, written in
    place. pages: (P,) this sequence's page row. Pad positions (j >=
    real_len) write to the scratch block. `adapters`/`adapter_id`: the
    LoRA pool and THIS sequence's pool row (an int; 0 = the identity),
    so the prompt's K/V rows are computed under the adapter the decode
    path serves; None without a pool.

    Returns (logits of position pfx_len+real_len-1, (1, V) f32, arena)."""
    return _prefill_pages_body(params, cfg, tokens, pfx_len, real_len,
                               arena, pages, adapters, adapter_id)


def gpt_prefill_chunk_pages(params, cfg, tokens, start_pos, real_len,
                            arena, pages, adapters=None,
                            adapter_id=None):
    """Budget-bounded CHUNKED-PREFILL pass: up to B suffix tokens of ONE
    sequence's prompt starting at absolute position `start_pos` (any
    position: the previous chunk's fill frontier). The math is
    gpt_prefill_pages' row for row, so N chunks give the same K/V rows
    and final logits as one monolithic dispatch.

    Returns (logits of position start_pos+real_len-1, (1, V) f32,
    arena)."""
    return _prefill_pages_body(params, cfg, tokens, start_pos, real_len,
                               arena, pages, adapters, adapter_id)


def _prefill_pages_body(params, cfg, tokens, pfx_len, real_len, arena,
                        pages, adapters=None, adapter_id=None):
    """Shared body of gpt_prefill_pages / gpt_prefill_chunk_pages."""
    heads, hd = cfg.heads, cfg.hidden // cfg.heads
    data, scales = _arena_parts(arena)
    dev = data.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    pages = torch.as_tensor(pages, device=dev).long()
    pfx_len, real_len = int(pfx_len), int(real_len)
    _b, B = tokens.shape
    bs = data.shape[4]
    n_pages = pages.shape[0]
    L = n_pages * bs
    dtype = _arena_compute_dtype(params, data, scales)
    row = None if adapters is None else int(adapter_id)
    j = torch.arange(B, device=dev)
    pos = pfx_len + j                              # absolute positions
    x = (params["wte"][tokens[0]] + _positions(params, pos)).to(dtype)
    mask = torch.arange(L, device=dev)[None, :] <= pos[:, None]
    # pad rows -> scratch block 0; the page index is clamped as XLA's
    # gather clamps (only pad rows can run past the page row)
    wblk = torch.where(j < real_len,
                       pages[(pos // bs).clamp(max=n_pages - 1)], 0)
    woff = pos % bs
    for li, blk in enumerate(params["blocks"]):
        la = _lora_layer(adapters, row, li, None)
        h = _ln(x, blk["ln1"])
        q = _dense_a(h, blk["q"], la["q"]).reshape(B, heads, hd)
        k = _dense_a(h, blk["k"], la["k"]).reshape(B, heads, hd)
        v = _dense_a(h, blk["v"], la["v"]).reshape(B, heads, hd)
        _kv_write(arena, li, 0, wblk, woff, k)
        _kv_write(arena, li, 1, wblk, woff, v)
        K = _kv_gather(arena, li, 0, pages, dtype)  # (heads, L, hd)
        V = _kv_gather(arena, li, 1, pages, dtype)
        scores = torch.einsum("bnd,nkd->bnk", q.float(), K.float())
        scores = torch.where(mask[:, None, :], scores / np.sqrt(hd),
                             _MASKED)
        probs = _softmax_rows(scores, dtype)
        ctx = torch.einsum("bnk,nkd->bnd", probs, V).reshape(B, -1)
        x = x + _dense_a(ctx, blk["out"], la["out"])
        x = _mlp_block(x, blk, la)
    last = x[real_len - 1][None, None]             # (1, 1, h)
    return _head_logits(params, last), arena


def _page_of(pt, ts, bs):
    """Each slot's page-table entry for position ts, the page index
    clamped to the row as XLA's gather clamps (a slot whose ts reached
    the end of its row reads the row's last entry)."""
    rows = torch.arange(pt.shape[0], device=pt.device)
    return pt[rows, (ts // bs).clamp(max=pt.shape[1] - 1)]


def gpt_decode_step_pages(params, cfg, tokens, arena, pt, ts, done=None,
                          adapters=None, adapter_ids=None):
    """One cached decode step over a PAGED pool: every slot advances at
    its own absolute position, its K/V living in arena blocks indirected
    through the page table. tokens/ts: (S,) ints, pt: (S, P) page table,
    arena: (layers, 2, num_blocks, heads, block_size, hd), written in
    place. Returns (logits (S, V) f32, arena).

    `done` (S,) bool redirects frozen slots' K/V writes to the scratch
    block 0 (their gathers still read stale blocks: garbage logits the
    host discards); done=None keeps every write live.

    `adapters`/`adapter_ids`: the LoRA pool and an (S,) tensor of pool
    rows, one a slot, so co-batched slots each run their own adapter in
    this one call (row 0 selects the base output); None without a
    pool."""
    heads = cfg.heads
    hd = cfg.hidden // cfg.heads
    data, scales = _arena_parts(arena)
    dev = data.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    ts = torch.as_tensor(ts, device=dev).long()
    pt = torch.as_tensor(pt, device=dev).long()
    bs = data.shape[4]
    s_dim, n_pages = pt.shape
    L = n_pages * bs
    dtype = _arena_compute_dtype(params, data, scales)
    live = None if adapters is None else (adapter_ids != 0)[:, None, None]
    x = (params["wte"][tokens]
         + _positions(params, ts)).to(dtype)[:, None]
    pos_mask = torch.arange(L, device=dev)[None, :] <= ts[:, None]
    wblk = _page_of(pt, ts, bs)
    if done is not None:
        wblk = torch.where(done, 0, wblk)      # frozen -> scratch block
    woff = ts % bs
    for li, blk in enumerate(params["blocks"]):
        la = _lora_layer(adapters, adapter_ids, li, live)
        h = _ln(x, blk["ln1"])
        q = _dense_a(h, blk["q"], la["q"]).reshape(s_dim, heads, 1, hd)
        k = _dense_a(h, blk["k"], la["k"]).reshape(s_dim, heads, hd)
        v = _dense_a(h, blk["v"], la["v"]).reshape(s_dim, heads, hd)
        _kv_write(arena, li, 0, wblk, woff, k)
        _kv_write(arena, li, 1, wblk, woff, v)
        K = _kv_gather(arena, li, 0, pt, dtype)    # (S, heads, L, hd)
        V = _kv_gather(arena, li, 1, pt, dtype)
        scores = torch.einsum("bnqd,bnkd->bnqk", q.float(), K.float())
        scores = torch.where(pos_mask[:, None, None, :],
                             scores / np.sqrt(hd), _MASKED)
        probs = _softmax_rows(scores, dtype)
        ctx = torch.einsum("bnqk,bnkd->bnqd", probs, V)
        ctx = ctx.transpose(1, 2).reshape(s_dim, 1, -1)
        x = x + _dense_a(ctx, blk["out"], la["out"])
        x = _mlp_block(x, blk, la)
    return _head_logits(params, x), arena


def greedy_sample(keys, logits, temps):
    """The chunk loop's default sampler: argmax (first index on ties),
    keys unchanged."""
    return logits.argmax(-1), keys


def gpt_decode_verify_pages(params, cfg, toks, arena, pt, ts, done=None,
                            adapters=None, adapter_ids=None):
    """gpt_decode_verify_slots over the PAGED pool: toks (S, D) at
    positions ts..ts+D-1 a slot, the D K/V writes through the page
    table. Two kinds of write go to the scratch block 0: those of `done`
    slots (a retired slot's reallocated blocks are never dirtied by its
    ride-along verify) and those whose page index runs past the row
    (pidx >= P: a draft's overshoot). Candidates at such positions read
    garbage and are never committed. `adapters`/`adapter_ids` as in
    gpt_decode_step_pages. Returns (logits (S, D, V) f32, arena)."""
    heads = cfg.heads
    hd = cfg.hidden // cfg.heads
    data, scales = _arena_parts(arena)
    dev = data.device
    toks = torch.as_tensor(toks, device=dev).long()
    ts = torch.as_tensor(ts, device=dev).long()
    pt = torch.as_tensor(pt, device=dev).long()
    bs = data.shape[4]
    s_dim, n_pages = pt.shape
    D = toks.shape[1]
    L = n_pages * bs
    dtype = _arena_compute_dtype(params, data, scales)
    live = None if adapters is None else (adapter_ids != 0)[:, None, None]
    rows = torch.arange(s_dim, device=dev)[:, None]
    pos = ts[:, None] + torch.arange(D, device=dev)[None, :]     # (S, D)
    x = (params["wte"][toks] + _positions(params, pos)).to(dtype)
    pos_mask = torch.arange(L, device=dev)[None, None, :] <= pos[:, :, None]
    pidx = pos // bs
    wblk = torch.where(pidx < n_pages,
                       pt[rows, pidx.clamp(max=n_pages - 1)], 0)
    if done is not None:
        wblk = torch.where(done[:, None], 0, wblk)
    woff = pos % bs
    for li, blk in enumerate(params["blocks"]):
        la = _lora_layer(adapters, adapter_ids, li, live)
        h = _ln(x, blk["ln1"])
        q = _dense_a(h, blk["q"], la["q"]).reshape(s_dim, D, heads, hd)
        k = _dense_a(h, blk["k"], la["k"]).reshape(s_dim, D, heads, hd)
        v = _dense_a(h, blk["v"], la["v"]).reshape(s_dim, D, heads, hd)
        _kv_write(arena, li, 0, wblk, woff, k)
        _kv_write(arena, li, 1, wblk, woff, v)
        K = _kv_gather(arena, li, 0, pt, dtype)    # (S, heads, L, hd)
        V = _kv_gather(arena, li, 1, pt, dtype)
        scores = torch.einsum("bqnd,bnkd->bnqk", q.float(), K.float())
        scores = torch.where(pos_mask[:, None], scores / np.sqrt(hd),
                             _MASKED)
        probs = _softmax_rows(scores, dtype)
        ctx = torch.einsum("bnqk,bnkd->bqnd", probs, V).reshape(
            s_dim, D, -1)
        x = x + _dense_a(ctx, blk["out"], la["out"])
        x = _mlp_block(x, blk, la)
    x = _ln(x, params["lnf"])
    return (x @ params["wte"].T.to(x.dtype)).float(), arena


# -- speculative decoding: the n-gram drafter and the accept step ------------

_HASH_A = 2654435761          # 0x9E3779B1
_HASH_B = 40503


def _ngram_hash(a, b, size):
    """Hash a 2-token drafter context into [0, size), bit-equal to the
    JAX function's uint32 math: a and b taken mod 2^32, each product
    mod 2^32, XOR, then % size. int64 throughout; the first product runs
    as two 16-bit halves, so no intermediate reaches 2^49."""
    a = torch.as_tensor(a).long() & _M32
    b = torch.as_tensor(b).long() & _M32
    ua = ((((a * (_HASH_A >> 16)) & 0xFFFF) << 16)
          + a * (_HASH_A & 0xFFFF)) & _M32
    ub = (b * _HASH_B) & _M32
    return (ua ^ ub) % int(size)


def spec_ngram_seed(table, slot, tokens, real_len):
    """Reset one slot's drafter row and seed it with the prompt's
    trigram statistics: context (tokens[j-2], tokens[j-1]) predicts
    tokens[j] for every real j. tokens: (B,) right-padded prompt suffix;
    real_len: its real length. table: (S, T+1) int64 written in place
    and returned; column T is the trash column the pad positions land
    in, -1 marks "no prediction". Where two positions name one column,
    the later position's token wins (XLA's scatter order), resolved as a
    max over positions so every device agrees."""
    slot = int(slot)
    size = table.shape[1] - 1
    tokens = torch.as_tensor(tokens, device=table.device).long()
    B = tokens.shape[0]
    if B < 3:
        table[slot] = -1
        return table
    j = torch.arange(B - 2, device=table.device)
    idx = _ngram_hash(tokens[:-2], tokens[1:-1], size)
    idx = torch.where(j + 2 < real_len, idx, size)
    last = torch.full((size + 1,), -1, dtype=torch.int64,
                      device=table.device)
    last.scatter_reduce_(0, idx, j, reduce="amax")
    table[slot] = torch.where(last >= 0, tokens[2:][last.clamp(min=0)],
                              -1)
    return table


def _spec_step(verify, sample_fn, temps, eos_ids, speculate_k, carry):
    """One draft -> verify -> accept pass of the speculative chunk loop,
    shared by the slab and paged loops. carry = (tok, pool, ts, keys,
    done, rem, prev, table); verify(inputs (S, k+1), pool, ts, done) ->
    (logits (S, k+1, V), pool); sample_fn is the whole-pool sampler.
    Returns (carry', (out (k+1, S), counts (S,))).

    Acceptance is EXACT-MATCH against the sampler's own draw: candidate
    j is sampled from logits j with the key after j splits (the
    sequential schedule), and is valid only while every draft before it
    matched, so each committed token is bit for bit what the
    non-speculative path emits with the same seed. EOS/budget stops end
    the committed run at the finish token; a frozen slot re-emits its
    token with count 1 and its key advances one split. The table is
    written in place, one column at a time in order, so where a pass
    names one column twice the later write wins on every device."""
    k = int(speculate_k)
    tok, pool, ts, keys, done, rem, prev, table = carry
    s_dim = tok.shape[0]
    dev = tok.device
    rows = torch.arange(s_dim, device=dev)
    size = table.shape[1] - 1
    # draft: k chained trigram lookups; a miss (-1) proposes token 0
    drafts = []
    a, b = prev, tok
    for _ in range(k):
        d = table[rows, _ngram_hash(a, b, size)]
        d = torch.where(d < 0, 0, d)
        drafts.append(d)
        a, b = b, d
    inputs = torch.stack([tok] + drafts, dim=1)          # (S, k+1)
    logits, pool = verify(inputs, pool, ts, done)
    cands, chain, cur = [], [keys], keys
    for j in range(k + 1):
        cj, cur = sample_fn(cur, logits[:, j], temps)
        cands.append(cj)
        chain.append(cur)
    cands = torch.stack(cands, dim=1)                    # (S, k+1)
    chain = torch.stack(chain, dim=1)                    # (S, k+2, 2)
    dr = torch.stack(drafts, dim=1)                      # (S, k)
    # candidate j is valid only while drafts 0..j-1 all matched
    lead = torch.cumprod((cands[:, :k] == dr).long(), dim=1)
    base = torch.cat([torch.ones((s_dim, 1), dtype=torch.bool,
                                 device=dev), lead.bool()], dim=1)
    jj = torch.arange(k + 1, device=dev)[None, :]
    stop = (cands == eos_ids[:, None]) | (rem[:, None] - (jj + 1) <= 0)
    stopped_before = torch.cat(
        [torch.zeros((s_dim, 1), dtype=torch.bool, device=dev),
         torch.cumsum(stop.long(), dim=1)[:, :-1] > 0], dim=1)
    can = base & ~stopped_before             # monotone commit mask
    c = can.sum(dim=1)                       # >= 1: j = 0 always commits
    live = ~done
    last = cands[rows, c - 1]
    prev_commit = torch.where(c >= 2, cands[rows, (c - 2).clamp(min=0)],
                              tok)
    ndone = done | (can & stop).any(dim=1)
    # every committed token registered under its 2-token context;
    # frozen slots and rejected tails write the trash column
    seq = torch.cat([prev[:, None], tok[:, None], cands], dim=1)
    idx = _ngram_hash(seq[:, :k + 1], seq[:, 1:k + 2], size)
    idx = torch.where(can & live[:, None], idx, size)
    for j in range(k + 1):
        table[rows, idx[:, j]] = cands[:, j]
    out = torch.where(live[:, None],
                      torch.where(can, cands, last[:, None]), tok[:, None])
    counts = torch.where(live, c, 1)
    keys = chain[rows, counts]
    tok = torch.where(live, last, tok)
    prev = torch.where(live, prev_commit, prev)
    ts = torch.where(live, ts + c, ts)
    rem = torch.where(live, rem - c, rem)
    return ((tok, pool, ts, keys, ndone, rem, prev, table),
            (out.T, counts))


def gpt_decode_chunk_pages(params, cfg, tokens, arena, pt, ts, keys,
                           temps, done, remaining, eos_ids, chunk,
                           sample_fn=None, speculate_k=0,
                           spec_state=None, adapters=None,
                           adapter_ids=None):
    """`chunk` iterations of gpt_decode_step_pages + per-slot sampling +
    EOS/budget masking, queued back to back on the arena's device: the
    counterpart of the JAX function's lax.scan. Every mask and counter
    stays a device tensor and nothing reads a value back to the host
    inside the loop, so one call queues the whole chunk without a sync.

    tokens/ts/remaining/eos_ids: (S,) int64, keys: (S, 2) sampler keys,
    temps: (S,) f32, done: (S,) bool. A frozen slot re-emits its last
    token, never advances ts, decrements nothing, and writes K/V to the
    scratch block; a slot freezes the moment it emits its eos id (-1 =
    none) or its budget reaches zero. sample_fn(keys, logits, temps) ->
    (tokens (S,), keys') draws for the whole pool; keys advance every
    iteration for every slot, frozen ones included, so a request's
    seeded stream does not depend on the chunk size. None means greedy
    argmax. The page table is read-only here.

    Returns (block (chunk, S) int64 — block[i, s] is slot s's i-th
    in-chunk token — tokens, arena, ts, keys, done, remaining).

    SPECULATIVE MODE (speculate_k > 0): as in gpt_decode_chunk_slots,
    each iteration drafts speculate_k tokens from spec_state = (prev,
    table), verifies them in one gpt_decode_verify_pages pass (frozen
    slots' and past-the-row writes to scratch) and commits the accepted
    run plus one corrected token. Returns (block (chunk, k+1, S), counts
    (chunk, S), tokens, arena, ts, keys, done, remaining, (prev,
    table)).

    `arena` may be the (int8 data, f32 scales) pair: every write
    quantizes, every gather dequantizes. `adapters`/`adapter_ids` (the
    LoRA pool and the (S,) pool rows of the carry) reach every step or
    verify pass; both are read-only here."""
    if sample_fn is None:
        sample_fn = greedy_sample
    if int(speculate_k) > 0:
        prev, table = spec_state

        def verify(inputs, arena, ts, done):
            return gpt_decode_verify_pages(params, cfg, inputs, arena, pt,
                                           ts, done, adapters=adapters,
                                           adapter_ids=adapter_ids)

        block, counts, carry = _spec_loop(
            verify, sample_fn, temps, eos_ids, speculate_k, chunk,
            (tokens, arena, ts, keys, done, remaining, prev, table))
        tokens, arena, ts, keys, done, remaining, prev, table = carry
        return (block, counts, tokens, arena, ts, keys, done, remaining,
                (prev, table))

    def step(tok, arena, ts, done):
        return gpt_decode_step_pages(params, cfg, tok, arena, pt, ts, done,
                                     adapters=adapters,
                                     adapter_ids=adapter_ids)

    return _chunk_loop(step, sample_fn, tokens, arena, ts, keys, temps,
                       done, remaining, eos_ids, chunk)


# -- serving sampler PRNG -----------------------------------------------------
#
# The serving engine draws per-slot samples whose streams must not depend
# on the slot, the co-batched load or the chunk size: a counter-based
# threefry2x32 (Random123, the function jax's CPU PRNG is built on) with
# Gumbel-max on top, a pure function of (key, logits, temperature). The
# uint32 arithmetic runs in int64 with a mask after every add and left
# shift (torch's uint32 lacks arithmetic and shifts on some devices), so
# every value stays in [0, 2^32) and the result is bit-equal to jax's.

_M32 = 0xFFFFFFFF


def threefry2x32(key, x0, x1):
    """Random123 threefry2x32 (20 rounds), bit-equal to the JAX
    function. key: (..., 2) int64 holding uint32 values (leading dims
    broadcast); x0/x1: counters (int64 tensors or ints in [0, 2^32)),
    broadcastable against the key's leading dims. Returns (y0, y1) int64
    in [0, 2^32)."""
    k0 = key[..., 0]
    k1 = key[..., 1]
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32

    def rotl(v, d):
        return ((v << d) & _M32) | (v >> (32 - d))

    rots = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (k0, k1, k2)
    for g in range(5):
        for r in rots[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _M32
    return x0, x1


def sample_key(seed, device=None):
    """Pack an integer seed into a (2,) sampler key (int64 holding
    uint32 values): [0, seed mod 2^32], the twin of JAX's sample_key."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def sample_split(key):
    """Advance sampler keys one step: counter (1, 0) of each key's
    threefry stream. key: (..., 2). Draws use counter (0, lane), so a
    key's draw never aliases its successor's."""
    y0, y1 = threefry2x32(key, 1, 0)
    return torch.stack([y0, y1], dim=-1)


def sample_gumbel(key, n):
    """(..., n) standard-Gumbel draws from each key's counters
    (0, 0..n-1): argmax(logits/temp + gumbel) is a categorical draw. u is
    centered on the 2^-24 lattice so both logs stay finite."""
    lanes = torch.arange(n, dtype=torch.int64, device=key.device)
    bits, _ = threefry2x32(key[..., None, :], 0, lanes)
    u = ((bits >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)
    return -torch.log(-torch.log(u))


def _top_k_desc(x, k):
    """The k largest values of each row and their indices, equal values
    ordered lowest index first (jax.lax.top_k's order; torch.topk does
    not promise one)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def make_sampler(top_k):
    """The serving engine's per-slot sampler over the whole pool:
    threefry2x32 + Gumbel-max with a per-slot temperature (0 = greedy).
    Noise is drawn and the key advanced for every slot, greedy and
    frozen ones included, as the JAX engine's vmapped `_sample_row`
    does. Returns sample(keys (S, 2), logits (S, V), temps (S,)) ->
    (tokens (S,) int64, keys' (S, 2))."""
    top_k = int(top_k)

    def sample(keys, logits, temps):
        key_next = sample_split(keys)
        greedy = logits.argmax(-1)
        scaled = logits / temps.clamp(min=1e-6)[:, None]
        if top_k > 0:
            vals, idx = _top_k_desc(scaled, top_k)
            g = sample_gumbel(keys, top_k)
            drawn = idx.gather(-1, (vals + g).argmax(-1, keepdim=True))[:, 0]
        else:
            g = sample_gumbel(keys, logits.shape[-1])
            drawn = (scaled + g).argmax(-1)
        return torch.where(temps > 0.0, drawn, greedy), key_next

    return sample


# -- sequential generation ----------------------------------------------------

def _sample(logits, gen, temperature, top_k):
    if temperature == 0.0:                      # greedy
        return logits.argmax(-1)
    logits = logits / temperature
    if top_k > 0:
        vals, idx = _top_k_desc(logits, top_k)
        choice = torch.multinomial(torch.softmax(vals, -1), 1,
                                   generator=gen)
        return idx.gather(-1, choice)[:, 0]
    return torch.multinomial(torch.softmax(logits, -1), 1,
                             generator=gen)[:, 0]


def gpt_generate(params, cfg, prompt, max_new_tokens,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None, seed: int = 0):
    """Generate continuations. prompt: (b, P) int array. temperature=0 is
    greedy (token for token the JAX function's); top_k>0 samples among
    the k best at the given temperature. A Python loop over
    gpt_decode_step on the parameters' device. Sampling draws from a
    torch.Generator seeded with `seed`: its streams are not those of
    jax.random.categorical. Returns the (b, P + max_new_tokens) numpy
    array."""
    p_len = int(np.asarray(prompt).shape[1])
    if p_len + int(max_new_tokens) > cfg.max_pos:
        raise ValueError(
            f"prompt ({p_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds cfg.max_pos ({cfg.max_pos})")
    dev = params["wte"].device
    prompt = torch.as_tensor(np.asarray(prompt), device=dev).long()
    b = prompt.shape[0]
    total = p_len + int(max_new_tokens)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        logits, cache = gpt_prefill(params, cfg, prompt, total)
        out = [prompt]
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        for i in range(int(max_new_tokens)):
            nxt = _sample(logits, gen, float(temperature), int(top_k))
            if eos_id is not None:
                nxt = torch.where(done, eos_id, nxt)
                done = done | (nxt == eos_id)
            out.append(nxt[:, None])
            logits, cache = gpt_decode_step(params, cfg, nxt, cache,
                                            p_len + i)
    return torch.cat(out, 1).cpu().numpy().astype(np.int32)
