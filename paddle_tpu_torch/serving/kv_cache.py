"""Paged KV-cache manager for the continuous-batching scheduler.

Port of `paddle_tpu/serving/kv_cache.py`. The pool is a fixed-shape
BLOCK ARENA `(layers, 2, num_blocks, heads, block_size, head_dim)` — one
torch tensor on the engine's device — plus one page table `(num_slots,
max_pages)`: a "slot" is one sequence's page-table row, and its K/V rows
live scattered across arena blocks (vLLM-style PagedAttention). Device
memory is paid per PAGE, not per worst-case context: a 10-token request
holds one block, not max_len rows.

On top of the allocator sits a HASHED PREFIX CACHE: prompt prefixes are
hashed at block granularity (a chained blake2b per full block), and a
new admission whose leading blocks match cached ones maps those blocks
into its page row (refcounted) instead of re-prefilling them. Blocks
whose refcount drops to zero but that still carry a registered hash go
to an LRU pool: they keep serving hits until arena pressure evicts them.
Copy-on-write discipline: only blocks FULLY covered by the shareable
prompt region (never the block holding position p_len-1, which the
decode tail writes into) are ever shared.

Block index 0 is the reserved SCRATCH block: never allocated, it absorbs
the ride-along writes of frozen slots (see gpt_decode_step_pages) and
the page-row padding past a sequence's tail.

Host-side bookkeeping (slots/blocks/refcounts/hashes) lives here; the
scheduler writes the arena in place (the JAX engine donates it), so
`cache.kv` is the same tensor for the engine's life.

Not ported yet: the int8 arena with its scale plane (`kv_dtype`), a
sharded arena (`mesh_shards`, `arena_device`) — each raises
NotImplementedError — and the host-swap adoption helpers
(`can_adopt`, `adopt_blocks`, `mapped_block_count`, `blocks_needed`),
which only preemption uses (ROADMAP A.1).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["ShapeBuckets", "SlotKVCache"]


class ShapeBuckets:
    """The small fixed set of padded prompt lengths prefill compiles for.

    bucket_for(n) returns the smallest bucket >= n; a prompt longer than
    the largest bucket is a caller error (the engine validates at
    submit), so admission can never trigger an unplanned compile."""

    def __init__(self, sizes: Sequence[int]):
        sizes = sorted(set(int(s) for s in sizes))
        if not sizes:
            raise ValueError("ShapeBuckets needs at least one size")
        if sizes[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {sizes[0]}")
        self.sizes: Tuple[int, ...] = tuple(sizes)

    def __len__(self):
        return len(self.sizes)

    def __iter__(self):
        return iter(self.sizes)

    @property
    def max(self) -> int:
        return self.sizes[-1]

    def bucket_for(self, n: int) -> int:
        for s in self.sizes:
            if s >= n:
                return s
        raise ValueError(
            f"prompt length {n} exceeds the largest prefill bucket "
            f"{self.sizes[-1]}")


SCRATCH_BLOCK = 0


class SlotKVCache:
    """Paged block arena + slot/page allocator + hashed prefix cache.

    kv: (layers, 2, num_blocks, heads, block_size, head_dim) — the block
    arena (block 0 is scratch, never allocated). A slot is a page-table
    row of up to max_pages block ids; admission maps exactly the pages a
    request's prompt+budget needs (`blocks_for(p_len + max_new)`), so
    the arena packs short requests densely instead of paying max_len per
    slot. `length(slot)` still tracks live positions for occupancy
    reporting.

    num_blocks defaults to slab-equivalent capacity (num_slots ×
    max_pages + scratch) so a paged pool is a drop-in replacement; size
    it DOWN (or num_slots UP) to oversubscribe worst-case contexts —
    admission falls back to queueing when pages run out."""

    def __init__(self, cfg, num_slots: int, max_len: int, dtype=None,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache: bool = True, mesh_shards: int = 1,
                 arena_device=None, kv_dtype: Optional[str] = None,
                 device=None):
        if mesh_shards != 1 or arena_device is not None:
            raise NotImplementedError(
                "a sharded KV arena (mesh_shards / arena_device) is not "
                "ported yet (ROADMAP A.8)")
        if kv_dtype is not None:
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r} is not ported yet (ROADMAP A.1.4: "
                "int8 weights and KV)")
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.mesh_shards = 1
        self.cfg = cfg
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.block_size = int(block_size)
        self.max_pages = -(-self.max_len // self.block_size)  # ceil
        if num_blocks is None:
            num_blocks = self.num_slots * self.max_pages + 1
        self.num_blocks = int(num_blocks)
        if self.num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (scratch + 1), got {num_blocks}")
        self.prefix_cache_enabled = bool(prefix_cache)
        heads, hd = cfg.heads, cfg.hidden // cfg.heads
        self.dtype = dtype if dtype is not None else torch.float32
        shape = (cfg.layers, 2, self.num_blocks, heads, self.block_size,
                 hd)
        # the arena: allocated once, written in place by every dispatch
        self.kv = torch.zeros(shape, dtype=self.dtype, device=device)
        self._pool_bytes = self.kv.numel() * self.kv.element_size()
        # -- slot allocator (page-table rows) --
        self._free = list(range(self.num_slots - 1, -1, -1))  # pop->0,1,..
        self._free_set = set(self._free)           # O(1) double-free check
        self._len = [0] * self.num_slots
        self._slot_blocks: List[List[int]] = [[] for _ in
                                              range(self.num_slots)]
        # host mirror of the device page table (scratch-filled rows)
        self.page_table = np.zeros((self.num_slots, self.max_pages),
                                   np.int32)
        # -- block allocator (block 0 = scratch, never handed out) --
        self._free_blocks = list(range(self.num_blocks - 1, 0, -1))
        self._ref = [0] * self.num_blocks
        # -- hashed prefix cache --
        # digest -> block for EVERY registered block (whatever refcount);
        # _lru is the evictable subset (refcount 0), insertion order =
        # eviction order (oldest first; free(slot) re-inserts a retiring
        # sequence's deepest blocks first so shallow prefix blocks — the
        # likeliest future hits — are evicted last)
        self._by_hash: Dict[bytes, int] = {}
        self._hash_of: Dict[int, bytes] = {}
        self._lru: "OrderedDict[bytes, int]" = OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.peak_blocks_used = 0
        # one-entry admission-plan memo: can_map() and the map_slot()
        # that immediately follows share one digest walk instead of
        # hashing the prompt twice; any allocator mutation invalidates
        self._plan_gen = 0
        self._plan_cache = None
        # deferred prefix-cache registration (chunked prefill):
        # slot -> [(block index in the page row, digest, block)] of
        # fresh full prompt blocks NOT yet published to the hash table —
        # a block only registers once the chunk dispatch that fills it
        # has been enqueued (register_prefix), so a concurrent
        # admission can never hash-hit unfilled rows. Dropped whole on
        # free(slot) (cancel/preempt mid-prefill).
        self._pending_reg: Dict[int, List[Tuple[int, bytes, int]]] = {}

    # -- slot allocation ----------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return self.num_slots - len(self._free)

    def alloc(self) -> Optional[int]:
        """Claim a free slot (page-table row); None when every row is
        occupied (the scheduler leaves the request queued). Pages are
        mapped separately by map_slot()."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._free_set.discard(slot)
        return slot

    def free(self, slot: int):
        """Release a slot: every mapped block is unreferenced (cached
        prefix blocks fall back to the LRU pool, private blocks to the
        free list) and the page row resets to scratch."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(
                f"free() of slot {slot} out of range "
                f"[0, {self.num_slots})")
        if slot in self._free_set:
            raise ValueError(f"double free of slot {slot}")
        # deepest blocks decref'd (and LRU-inserted) first: shallow
        # prefix blocks land most-recently-used, evicted last
        # unpublished prefix digests die with the slot: their blocks'
        # fills may never have been dispatched (mid-prefill cancel)
        self._pending_reg.pop(slot, None)
        for b in reversed(self._slot_blocks[slot]):
            self._decref(b)
        self._slot_blocks[slot] = []
        self.page_table[slot, :] = SCRATCH_BLOCK
        self._len[slot] = 0
        self._free.append(slot)
        self._free_set.add(slot)

    # -- block accounting ---------------------------------------------------

    @property
    def blocks_total(self) -> int:
        """Allocatable blocks (scratch excluded)."""
        return self.num_blocks - 1

    @property
    def blocks_used(self) -> int:
        """Blocks referenced by at least one live slot."""
        return self.blocks_total - len(self._free_blocks) - len(self._lru)

    @property
    def blocks_cached(self) -> int:
        """Unreferenced blocks kept warm for prefix-cache hits (LRU-
        evicted under pressure)."""
        return len(self._lru)

    @property
    def blocks_available(self) -> int:
        """Blocks an admission can claim right now: free + evictable."""
        return len(self._free_blocks) + len(self._lru)

    def blocks_for(self, positions: int) -> int:
        """Pages needed to hold `positions` sequence positions."""
        if positions < 1:
            raise ValueError(f"positions must be >= 1, got {positions}")
        return (positions - 1) // self.block_size + 1

    def _incref(self, block: int) -> None:
        self._plan_gen += 1
        self._ref[block] += 1
        if self._ref[block] == 1:
            digest = self._hash_of.get(block)
            if digest is not None:
                self._lru.pop(digest, None)     # no longer evictable

    def _decref(self, block: int) -> None:
        if self._ref[block] <= 0:
            raise ValueError(f"refcount underflow on block {block}")
        self._plan_gen += 1
        self._ref[block] -= 1
        if self._ref[block] == 0:
            digest = self._hash_of.get(block)
            if digest is not None:
                self._lru[digest] = block       # evictable, MRU end
            else:
                self._free_blocks.append(block)

    def _take_block(self) -> int:
        """Claim one block for exclusive use, evicting the oldest
        unreferenced cached block if the free list is empty."""
        self._plan_gen += 1
        if self._free_blocks:
            return self._free_blocks.pop()
        digest, block = self._lru.popitem(last=False)   # oldest
        del self._by_hash[digest]
        del self._hash_of[block]
        return block

    # -- hashed prefix cache ------------------------------------------------

    def _chain_digests(self, prompt: np.ndarray, n_full: int,
                       adapter_id: int = 0):
        """Chained per-block digests: digest[i] commits to the whole
        prefix tokens[0 : (i+1)*block_size], so a hit at block i implies
        hits at every block before it. The adapter id SALTS the chain
        seed: a prefix computed under LoRA adapter k holds different
        K/V content than the same tokens under the base model (or any
        other adapter), so cross-adapter sharing would be silent output
        corruption. adapter_id=0 seeds with the legacy empty chain, so
        an adapterless engine's digests — and its cross-request sharing
        — are byte-identical to pre-adapter builds."""
        bs = self.block_size
        data = np.ascontiguousarray(prompt[:n_full * bs], np.int32)
        digests, h = [], b""
        if adapter_id:
            h = np.int64(adapter_id).tobytes()
        for i in range(n_full):
            h = hashlib.blake2b(
                h + data[i * bs:(i + 1) * bs].tobytes(),
                digest_size=16).digest()
            digests.append(h)
        return digests

    def _plan(self, prompt: np.ndarray,
              total_positions: int, adapter_id: int = 0
              ) -> Tuple[list, List[int], int, int, bool]:
        """The admission plan, computed WITHOUT mutating anything:
        (digests of registerable full blocks, hit block ids, count of
        hits currently in the LRU pool, total blocks needed,
        feasible-right-now). LRU hits would be claimed, not evicted,
        so they are excluded from the evictable supply — and they are
        what blocks_needed() charges against availability. Memoized
        per (prompt, total) until the next allocator mutation — the
        can_map() check and the map_slot() that follows share one
        digest walk."""
        key = (prompt.tobytes(), int(total_positions), int(adapter_id))
        if self._plan_cache is not None:
            gen, k, plan = self._plan_cache
            if gen == self._plan_gen and k == key:
                return plan
        p_len = prompt.size
        total_blocks = self.blocks_for(total_positions)
        # shareable: full blocks strictly before position p_len-1 (the
        # suffix prefill always recomputes the last prompt position)
        shareable = (p_len - 1) // self.block_size
        digests = self._chain_digests(prompt, p_len // self.block_size,
                                      adapter_id) \
            if self.prefix_cache_enabled else []
        hit_blocks: List[int] = []
        lru_hits = 0
        for i in range(min(shareable, len(digests))):
            block = self._by_hash.get(digests[i])
            if block is None:
                break
            hit_blocks.append(block)
            if self._ref[block] == 0:
                lru_hits += 1
        feasible = (total_blocks - len(hit_blocks)
                    <= len(self._free_blocks) + len(self._lru)
                    - lru_hits)
        plan = (digests, hit_blocks, lru_hits, total_blocks, feasible)
        self._plan_cache = (self._plan_gen, key, plan)
        return plan

    def can_map(self, prompt: np.ndarray, total_positions: int,
                adapter_id: int = 0) -> bool:
        """Feasibility of map_slot() RIGHT NOW, without mutating any
        allocator state — the engine's pages-aware admission check
        (stamp/count a request as admitted only when it will fit)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        return self._plan(prompt, total_positions, adapter_id)[4]

    def map_slot(self, slot: int, prompt: np.ndarray,
                 total_positions: int,
                 register: bool = True,
                 adapter_id: int = 0) -> Optional[Tuple[np.ndarray, int]]:
        """Map the pages a request needs into `slot`'s page row.

        prompt: the request's token ids; total_positions: p_len +
        max_new (every position the sequence may ever write). Leading
        FULL prompt blocks that hash-match cached ones are shared
        (refcounted) instead of allocated; the rest come from the free
        list, evicting LRU cached blocks under pressure. Returns
        (page_row (max_pages,) int32, prefix_len) — prefix_len is the
        number of leading positions already resident (a multiple of
        block_size; the prefill suffix starts there) — or None when the
        arena cannot hold the request right now (caller keeps it queued;
        the slot stays allocated and untouched).

        Sharing never includes the block holding position p_len-1: the
        suffix prefill always recomputes the last prompt position (its
        logits seed the first token), and the first block the request
        writes into is private by construction — the copy-on-write
        guarantee.

        `register=False` (chunked prefill) defers publishing this
        prompt's fresh full blocks to the prefix hash table: the caller
        releases them block by block via register_prefix() as the
        chunk dispatches that fill them are enqueued. Hits are still
        CONSUMED either way — deferral only gates what later
        admissions may share FROM this one."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p_len = prompt.size
        if not 1 <= total_positions <= self.max_pages * self.block_size:
            raise ValueError(
                f"total_positions {total_positions} out of range "
                f"[1, {self.max_pages * self.block_size}]")
        if p_len > total_positions:
            raise ValueError(
                f"prompt ({p_len}) longer than total_positions "
                f"({total_positions})")
        bs = self.block_size
        digests, claimed, _lru_hits, total_blocks, feasible = \
            self._plan(prompt, total_positions, adapter_id)
        if not feasible:
            return None
        for b in claimed:
            self._incref(b)
        if self.prefix_cache_enabled:
            self.prefix_hits += len(claimed)
            self.prefix_misses += (p_len - 1) // bs - len(claimed)
        blocks = claimed + [self._take_block() for _ in
                            range(total_blocks - len(claimed))]
        for b in blocks[len(claimed):]:
            self._incref(b)
        # register this prompt's fresh FULL blocks so later admissions
        # can share them (content is deterministic in the prefix tokens;
        # the filling prefill dispatch is enqueued before any dispatch
        # that could read a future hit — with register=False the caller
        # upholds that invariant chunk by chunk via register_prefix).
        # A digest already registered to another block keeps its
        # original mapping.
        pending = [(i, digests[i], blocks[i])
                   for i in range(len(claimed), len(digests))]
        if register:
            for _, d, b in pending:
                if d not in self._by_hash:
                    self._by_hash[d] = b
                    self._hash_of[b] = d
        elif pending:
            self._pending_reg[slot] = pending
        row = self._install_blocks(slot, blocks, p_len)
        return row, len(claimed) * bs

    def register_prefix(self, slot: int, frontier: int) -> None:
        """Publish `slot`'s deferred prefix digests for every full
        block now COVERED by the fill frontier (`frontier` = absolute
        positions whose filling dispatch is enqueued): block i
        registers once (i+1)*block_size <= frontier. The chunked-
        prefill caller invokes this right after each chunk dispatch,
        so device dispatch order guarantees a later hit's prefill
        reads filled rows. No-op for slots with nothing pending."""
        pending = self._pending_reg.get(slot)
        if not pending:
            return
        keep: List[Tuple[int, bytes, int]] = []
        for i, d, b in pending:
            if (i + 1) * self.block_size <= frontier:
                if d not in self._by_hash:
                    self._by_hash[d] = b
                    self._hash_of[b] = d
                    self._plan_gen += 1   # plans may now see the hit
            else:
                keep.append((i, d, b))
        if keep:
            self._pending_reg[slot] = keep
        else:
            self._pending_reg.pop(slot, None)

    def _install_blocks(self, slot: int, blocks, length: int):
        """Install already-claimed+increffed blocks into `slot`'s page
        row (scratch-padded) and update length/peak accounting."""
        self._slot_blocks[slot] = blocks
        row = np.full((self.max_pages,), SCRATCH_BLOCK, np.int32)
        row[:len(blocks)] = blocks
        self.page_table[slot] = row
        self._len[slot] = int(length)
        self.peak_blocks_used = max(self.peak_blocks_used,
                                    self.blocks_used)
        return row

    # -- per-slot length tracking ------------------------------------------

    def set_length(self, slot: int, n: int):
        if not 0 <= n <= self.max_len:
            raise ValueError(
                f"slot length {n} out of range [0, {self.max_len}]")
        self._len[slot] = int(n)

    def advance(self, slot: int):
        self.set_length(slot, self._len[slot] + 1)

    def length(self, slot: int) -> int:
        return self._len[slot]

    # -- arena ----------------------------------------------------------------

    @property
    def kv_dtype(self) -> str:
        """The arena's storage dtype name ("float32" / "bfloat16") — the
        string occupancy() reports."""
        return str(self.dtype).replace("torch.", "")

    @property
    def pool_bytes(self) -> int:
        """Whole-arena device footprint, constant for the engine's life
        (every dispatch writes the same tensor in place)."""
        return self._pool_bytes

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        """The arena's mesh geometry: (1,), one card."""
        return (self.mesh_shards,)

    @property
    def hbm_per_chip_bytes(self) -> int:
        """Arena bytes resident on the card (the whole arena: it is not
        sharded)."""
        return self._pool_bytes

    def occupancy(self) -> Dict[str, object]:
        return {"num_slots": self.num_slots,
                "active_slots": self.active_count,
                "free_slots": self.free_count,
                "live_positions": sum(self._len),
                "pool_bytes": self.pool_bytes,
                "hbm_per_chip_bytes": self.hbm_per_chip_bytes,
                "kv_dtype": self.kv_dtype,
                "mesh_shape": self.mesh_shape,
                "block_size": self.block_size,
                "blocks_total": self.blocks_total,
                "blocks_used": self.blocks_used,
                "blocks_cached": self.blocks_cached,
                "peak_blocks_used": self.peak_blocks_used,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses}
