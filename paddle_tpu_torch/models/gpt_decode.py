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

Not ported yet (ROADMAP A.1): the slot-slab functions
(`gpt_decode_step_slots`, `gpt_decode_chunk_slots`,
`gpt_decode_verify_slots`), speculative decoding
(`gpt_decode_verify_pages`, `_spec_step`, `spec_ngram_seed`), the int8
weight and KV paths (`quantize_params`, `_quantize_rows`) and the LoRA
adapter path (`_lora_layer`, `_dense_a`). The constants below name the
kernels those paths cover in the JAX package; the engine's validation
reads them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["collect_gpt_params", "gpt_forward_logits", "gpt_prefill",
           "gpt_prefill_padded", "gpt_decode_step", "gpt_prefill_pages",
           "gpt_prefill_chunk_pages", "gpt_decode_step_pages",
           "gpt_decode_chunk_pages", "gpt_generate",
           "QUANTIZED_KV_KERNELS", "ADAPTER_KERNELS",
           "ADAPTER_PROJECTIONS", "threefry2x32", "sample_key",
           "sample_split", "sample_gumbel"]

# The paged kernels whose in-graph KV dequant path exists in the JAX
# package (a quantized arena may only flow through kernels named here).
QUANTIZED_KV_KERNELS = ("gpt_prefill_pages", "gpt_prefill_chunk_pages",
                        "gpt_decode_step_pages",
                        "gpt_decode_chunk_pages",
                        "gpt_decode_verify_pages")

# The paged kernels whose per-slot LoRA gather-matmul path exists.
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


def collect_gpt_params(scope, cfg, prefix="gpt"):
    """Pull the GPT parameter tree out of an executor scope (the vars
    models/gpt.py's programs create). The tensors stay where the scope
    holds them (the engine runs on their device)."""

    def get(name):
        v = scope.find_var(name)
        if v is None:
            raise KeyError(f"param {name!r} not found in scope")
        return v

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


def param_tensors(params):
    """Every tensor of a parameter tree, in a fixed order."""
    out = [params["wte"], params["wpe"], params["lnf"]["g"],
           params["lnf"]["b"]]
    for blk in params["blocks"]:
        for nm in ("ln1", "ln2"):
            out += [blk[nm]["g"], blk[nm]["b"]]
        for nm in ADAPTER_PROJECTIONS:
            out += [blk[nm]["w"], blk[nm]["b"]]
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
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


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


def _mlp_block(x, blk):
    h = _ln(x, blk["ln2"])
    return x + _dense(_gelu_tanh(_dense(h, blk["mlp1"])), blk["mlp2"])


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


def _kv_write(arena, li, j, wblk, woff, val):
    """One K/V scatter (j = 0 for K, 1 for V) into the arena, in place:
    row woff[i] of block wblk[i] takes val[i] (heads, hd)."""
    plane = arena[li, j]                  # a view: the write lands in arena
    plane[wblk, :, woff] = val


def gpt_prefill_pages(params, cfg, tokens, pfx_len, real_len, arena,
                      pages):
    """Paged prefill of ONE sequence's prompt SUFFIX into its arena
    blocks, attending over an already-cached prefix through the page
    row.

    tokens: (1, B) suffix, right-padded to a shape bucket. pfx_len: how
    many leading prompt positions are already resident (prefix-cache
    hits, a multiple of the block size; 0 = cold prompt). real_len: the
    real suffix length, >= 1. arena: (layers, 2, num_blocks, heads,
    block_size, hd), written in place. pages: (P,) this sequence's page
    row. Pad positions (j >= real_len) write to the scratch block.

    Returns (logits of position pfx_len+real_len-1, (1, V) f32, arena)."""
    return _prefill_pages_body(params, cfg, tokens, pfx_len, real_len,
                               arena, pages)


def gpt_prefill_chunk_pages(params, cfg, tokens, start_pos, real_len,
                            arena, pages):
    """Budget-bounded CHUNKED-PREFILL pass: up to B suffix tokens of ONE
    sequence's prompt starting at absolute position `start_pos` (any
    position: the previous chunk's fill frontier). The math is
    gpt_prefill_pages' row for row, so N chunks give the same K/V rows
    and final logits as one monolithic dispatch.

    Returns (logits of position start_pos+real_len-1, (1, V) f32,
    arena)."""
    return _prefill_pages_body(params, cfg, tokens, start_pos, real_len,
                               arena, pages)


def _prefill_pages_body(params, cfg, tokens, pfx_len, real_len, arena,
                        pages):
    """Shared body of gpt_prefill_pages / gpt_prefill_chunk_pages."""
    heads, hd = cfg.heads, cfg.hidden // cfg.heads
    dev = arena.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    pages = torch.as_tensor(pages, device=dev).long()
    pfx_len, real_len = int(pfx_len), int(real_len)
    _b, B = tokens.shape
    bs = arena.shape[4]
    n_pages = pages.shape[0]
    L = n_pages * bs
    dtype = arena.dtype
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
        h = _ln(x, blk["ln1"])
        q = _dense(h, blk["q"]).reshape(B, heads, hd)
        k = _dense(h, blk["k"]).reshape(B, heads, hd)
        v = _dense(h, blk["v"]).reshape(B, heads, hd)
        _kv_write(arena, li, 0, wblk, woff, k)
        _kv_write(arena, li, 1, wblk, woff, v)
        K = _gather_pages(arena[li, 0], pages)     # (heads, L, hd)
        V = _gather_pages(arena[li, 1], pages)
        scores = torch.einsum("bnd,nkd->bnk", q.float(), K.float())
        scores = torch.where(mask[:, None, :], scores / np.sqrt(hd),
                             _MASKED)
        probs = _softmax_rows(scores, dtype)
        ctx = torch.einsum("bnk,nkd->bnd", probs, V).reshape(B, -1)
        x = x + _dense(ctx, blk["out"])
        x = _mlp_block(x, blk)
    last = x[real_len - 1][None, None]             # (1, 1, h)
    return _head_logits(params, last), arena


def _page_of(pt, ts, bs):
    """Each slot's page-table entry for position ts, the page index
    clamped to the row as XLA's gather clamps (a slot whose ts reached
    the end of its row reads the row's last entry)."""
    rows = torch.arange(pt.shape[0], device=pt.device)
    return pt[rows, (ts // bs).clamp(max=pt.shape[1] - 1)]


def gpt_decode_step_pages(params, cfg, tokens, arena, pt, ts, done=None):
    """One cached decode step over a PAGED pool: every slot advances at
    its own absolute position, its K/V living in arena blocks indirected
    through the page table. tokens/ts: (S,) ints, pt: (S, P) page table,
    arena: (layers, 2, num_blocks, heads, block_size, hd), written in
    place. Returns (logits (S, V) f32, arena).

    `done` (S,) bool redirects frozen slots' K/V writes to the scratch
    block 0 (their gathers still read stale blocks: garbage logits the
    host discards); done=None keeps every write live."""
    heads = cfg.heads
    hd = cfg.hidden // cfg.heads
    dev = arena.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    ts = torch.as_tensor(ts, device=dev).long()
    pt = torch.as_tensor(pt, device=dev).long()
    bs = arena.shape[4]
    s_dim, n_pages = pt.shape
    L = n_pages * bs
    dtype = arena.dtype
    x = (params["wte"][tokens]
         + _positions(params, ts)).to(dtype)[:, None]
    pos_mask = torch.arange(L, device=dev)[None, :] <= ts[:, None]
    wblk = _page_of(pt, ts, bs)
    if done is not None:
        wblk = torch.where(done, 0, wblk)      # frozen -> scratch block
    woff = ts % bs
    for li, blk in enumerate(params["blocks"]):
        h = _ln(x, blk["ln1"])
        q = _dense(h, blk["q"]).reshape(s_dim, heads, 1, hd)
        k = _dense(h, blk["k"]).reshape(s_dim, heads, hd)
        v = _dense(h, blk["v"]).reshape(s_dim, heads, hd)
        _kv_write(arena, li, 0, wblk, woff, k)
        _kv_write(arena, li, 1, wblk, woff, v)
        K = _gather_pages(arena[li, 0], pt)        # (S, heads, L, hd)
        V = _gather_pages(arena[li, 1], pt)
        scores = torch.einsum("bnqd,bnkd->bnqk", q.float(), K.float())
        scores = torch.where(pos_mask[:, None, None, :],
                             scores / np.sqrt(hd), _MASKED)
        probs = _softmax_rows(scores, dtype)
        ctx = torch.einsum("bnqk,bnkd->bnqd", probs, V)
        ctx = ctx.transpose(1, 2).reshape(s_dim, 1, -1)
        x = x + _dense(ctx, blk["out"])
        x = _mlp_block(x, blk)
    return _head_logits(params, x), arena


def greedy_sample(keys, logits, temps):
    """The chunk loop's default sampler: argmax (first index on ties),
    keys unchanged."""
    return logits.argmax(-1), keys


def gpt_decode_chunk_pages(params, cfg, tokens, arena, pt, ts, keys,
                           temps, done, remaining, eos_ids, chunk,
                           sample_fn=None):
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
    in-chunk token — tokens, arena, ts, keys, done, remaining)."""
    if sample_fn is None:
        sample_fn = greedy_sample
    rows = []
    tok = tokens
    for _ in range(int(chunk)):
        logits, arena = gpt_decode_step_pages(params, cfg, tok, arena, pt,
                                              ts, done)
        nxt, keys = sample_fn(keys, logits, temps)
        emit = torch.where(done, tok, nxt)
        remaining = torch.where(done, remaining, remaining - 1)
        ndone = done | (emit == eos_ids) | (remaining <= 0)
        ts = torch.where(done, ts, ts + 1)
        done = ndone
        tok = emit
        rows.append(emit)
    return torch.stack(rows), tok, arena, ts, keys, done, remaining


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
