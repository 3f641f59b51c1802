"""Multi-tenant LoRA adapter pool for the serving engine.

Port of `paddle_tpu/serving/adapters.py`: the pool is fp32 torch
tensors on the engine's device, and an upload is an indexed copy into
them (never a new tensor), so the arrays the scheduler passes to every
dispatch stay the same objects for the engine's life. `make_adapter`
draws from numpy with the seed and `_digest` hashes the same bytes, so
both are bit for bit the JAX package's: two replicas of either package
uploading `make_adapter(cfg, r, seed)` hold the same digest, which is
what a migration ticket checks.

The reference framework served per-customer fine-tunes by standing up
ONE service per parameter set (one ProgramDesc + executor per model);
this module is the multiplexing answer: thousands of low-rank variants
ride ONE base model on ONE engine. The pool is a fixed-shape device
tree

    {proj: {"a": (num_adapters, layers, in_dim, rank) f32,
            "b": (num_adapters, layers, rank, out_dim) f32}}

over the six decode projections (models/gpt_decode.ADAPTER_PROJECTIONS:
q/k/v/out/mlp1/mlp2). Fixed shapes are — as everywhere in this serving
stack — the whole point: the chunk loop gathers A/B rows by a per-slot
adapter-row vector riding the decode carry, so co-batched requests each
hit a DIFFERENT adapter inside one dispatch, the family count stays
O(buckets)+admit+1, and an upload is a value update at fixed shape.

ROW 0 IS THE RESERVED IDENTITY: all-zero A/B, never uploaded, never
evicted — `adapter_id=0` means "base model" and the kernels select the
untouched base activation for those slots (bit-identical to an
adapterless engine, not merely +0.0-close; see gpt_decode._dense_a).

Host-side bookkeeping mirrors the kv_cache block allocator's
refcount+LRU discipline: `upload()` claims a free row (evicting the
least-recently-used UNREFERENCED adapter under pressure — all rows
referenced is a typed pool-full error), `evict()` refuses while any
live slot still references the id, and `acquire()`/`release()` bracket
a request's lifetime exactly like block increfs/decrefs. Uploads are
validated against the base geometry up front — a rank or width
mismatch is a typed 4xx-able error, never a silent reshape.

Digests: every resident adapter's bytes are committed to a blake2b
digest at upload; migration tickets carry (adapter_id, digest) INSIDE
their checksum so a cross-replica handoff onto a pool holding
different bytes under the same id is a typed TicketError, not silent
output corruption (a ticket commits a quantized row's scale-plane bytes
the same way).
"""

from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.gpt_decode import ADAPTER_PROJECTIONS

__all__ = ["AdapterPool", "AdapterError", "UnknownAdapterError",
           "AdapterGeometryError", "AdapterPoolFullError",
           "AdapterReferencedError", "adapter_geometry", "make_adapter"]


class AdapterError(ValueError):
    """Base of every typed adapter failure. Subclasses ValueError so the
    HTTP layer's existing ValueError -> 400 mapping covers the whole
    family without a second error plane."""


class UnknownAdapterError(AdapterError):
    """The requested adapter id is not resident in the pool (the typed
    4xx for a tenant routing to an adapter nobody uploaded)."""


class AdapterGeometryError(AdapterError):
    """Uploaded weights do not match the base model geometry / pool
    rank — refused up front, never silently reshaped."""


class AdapterPoolFullError(AdapterError):
    """Every pool row is referenced by a live request; upload must wait
    for a release (the adapter analog of pages running out)."""


class AdapterReferencedError(AdapterError):
    """evict()/re-upload refused: a live slot still references the id —
    swapping weights under a running stream would corrupt its output."""


def adapter_geometry(cfg, rank: int) -> Dict[str, Tuple[Tuple[int, ...],
                                                        Tuple[int, ...]]]:
    """Per-projection ((layers, in, rank), (layers, rank, out)) shapes
    an upload must match exactly — THE geometry contract, shared by the
    pool allocator, upload validation, and make_adapter()."""
    h, f, nl = int(cfg.hidden), int(cfg.ffn), int(cfg.layers)
    dims = {"q": (h, h), "k": (h, h), "v": (h, h), "out": (h, h),
            "mlp1": (h, f), "mlp2": (f, h)}
    return {nm: ((nl, dims[nm][0], rank), (nl, rank, dims[nm][1]))
            for nm in ADAPTER_PROJECTIONS}


def make_adapter(cfg, rank: int, seed: int) -> Dict[str, Dict[str, np.ndarray]]:
    """Deterministic synthetic adapter for tests and benches: both A and
    B drawn small-normal from `seed` (unlike training-style LoRA init,
    B is NOT zero — a zero delta would be indistinguishable from the
    base model, defeating identity tests that must tell adapters
    apart). The 0.3 scale is deliberate: the low-rank delta goes as
    scale^2, and the tests need a perturbation strong enough to steer
    greedy argmax away from the base model's tokens (0.05-style init
    moves tiny-GPT logits by ~0.02 against a ~0.7 spread — invisible
    to token-identity assertions). Same (cfg, rank, seed) =>
    bit-identical bytes on every host, which is what lets two replicas
    upload "the same adapter" and pass the migration digest check."""
    rng = np.random.default_rng(int(seed))
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for nm, (sa, sb) in adapter_geometry(cfg, rank).items():
        out[nm] = {
            "a": (0.3 * rng.standard_normal(sa)).astype(np.float32),
            "b": (0.3 * rng.standard_normal(sb)).astype(np.float32)}
    return out


class AdapterPool:
    """Device-resident LoRA pool + host refcount/LRU row allocator.

    pool: the `{proj: {"a", "b"}}` tree described in the module
    docstring, on `device` — what the scheduler passes (read-only) into
    every dispatch.

    Rows are claimed by `upload()` and map logical adapter ids (any
    int >= 1 a tenant chooses) to pool rows; `row_of()` is what the
    engine stamps into the decode carry at admission. Row 0 is the
    identity and belongs to adapter id 0 forever.
    """

    def __init__(self, cfg, max_adapters: int, rank: int, device=None):
        if not isinstance(max_adapters, int) or max_adapters < 2:
            raise AdapterGeometryError(
                f"max_adapters must be an int >= 2 (row 0 is the "
                f"reserved identity), got {max_adapters!r}")
        if not isinstance(rank, int) or rank < 1:
            raise AdapterGeometryError(
                f"adapter_rank must be an int >= 1, got {rank!r}")
        self.cfg = cfg
        self.max_adapters = int(max_adapters)
        self.rank = int(rank)
        self.geometry = adapter_geometry(cfg, rank)
        n = self.max_adapters
        self.pool = {}
        self._pool_bytes = 0
        for nm, (sa, sb) in self.geometry.items():
            self.pool[nm] = {
                "a": torch.zeros((n,) + sa, dtype=torch.float32,
                                 device=device),
                "b": torch.zeros((n,) + sb, dtype=torch.float32,
                                 device=device)}
            self._pool_bytes += (math.prod((n,) + sa)
                                 + math.prod((n,) + sb)) * 4
        # -- host bookkeeping (kv_cache refcount+LRU discipline) --
        # logical id -> pool row; row 0 / id 0 is the pinned identity
        self._rows: Dict[int, int] = {0: 0}
        self._free_rows = list(range(self.max_adapters - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        # unreferenced resident ids, insertion order = eviction order
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._digests: Dict[int, bytes] = {}
        self.uploads_total = 0
        self.evictions_total = 0

    # -- geometry / digests --------------------------------------------------

    def _validate(self, adapter_id: int, weights) -> Dict[str, Dict[str,
                                                                    np.ndarray]]:
        if not isinstance(adapter_id, int) or adapter_id < 1:
            raise AdapterGeometryError(
                f"adapter_id must be an int >= 1 (0 is the reserved "
                f"base identity), got {adapter_id!r}")
        missing = [nm for nm in ADAPTER_PROJECTIONS
                   if nm not in (weights or {})]
        if missing:
            raise AdapterGeometryError(
                f"adapter {adapter_id} upload missing projection(s) "
                f"{missing}: expected A/B pairs for all of "
                f"{list(ADAPTER_PROJECTIONS)}")
        clean = {}
        for nm in ADAPTER_PROJECTIONS:
            want_a, want_b = self.geometry[nm]
            a = np.ascontiguousarray(weights[nm]["a"], np.float32)
            b = np.ascontiguousarray(weights[nm]["b"], np.float32)
            if a.shape != want_a or b.shape != want_b:
                raise AdapterGeometryError(
                    f"adapter {adapter_id} projection {nm!r} geometry "
                    f"mismatch: got A{a.shape} B{b.shape}, base model "
                    f"at rank {self.rank} needs A{want_a} B{want_b}")
            clean[nm] = {"a": a, "b": b}
        return clean

    @staticmethod
    def _digest(clean: Dict[str, Dict[str, np.ndarray]]) -> bytes:
        """blake2b over the adapter's bytes in canonical projection
        order — the content commitment migration tickets fold into
        their checksum."""
        h = hashlib.blake2b(digest_size=16)
        for nm in ADAPTER_PROJECTIONS:
            h.update(nm.encode())
            h.update(clean[nm]["a"].tobytes())
            h.update(clean[nm]["b"].tobytes())
        return h.digest()

    def digest_of(self, adapter_id: int) -> bytes:
        """The resident adapter's content digest (b"" for the base
        identity 0) — what migration stamps into tickets and what
        validate_for compares against the target pool."""
        if adapter_id == 0:
            return b""
        if adapter_id not in self._rows:
            raise UnknownAdapterError(
                f"adapter {adapter_id} is not resident "
                f"(resident: {sorted(self._rows)})")
        return self._digests[adapter_id]

    # -- upload / evict ------------------------------------------------------

    def upload(self, adapter_id: int, weights) -> int:
        """Validate + install an adapter's A/B stack under `adapter_id`,
        returning its pool row. Re-uploading a resident UNREFERENCED id
        overwrites it in place (and refreshes its LRU position);
        re-uploading a referenced id is refused — live streams would
        change weights mid-decode. A fresh id claims a free row, LRU-
        evicting the oldest unreferenced adapter under pressure; with
        every row referenced the upload is a typed pool-full error.

        Device-side this is an indexed copy into the pool's tensors
        (the same objects before and after)."""
        clean = self._validate(adapter_id, weights)
        if adapter_id in self._rows:
            if self._ref.get(adapter_id, 0) > 0:
                raise AdapterReferencedError(
                    f"adapter {adapter_id} is referenced by "
                    f"{self._ref[adapter_id]} live request(s); "
                    "re-upload would change weights under running "
                    "streams")
            row = self._rows[adapter_id]
            self._lru.pop(adapter_id, None)
        elif self._free_rows:
            row = self._free_rows.pop()
        elif self._lru:
            victim, _ = self._lru.popitem(last=False)    # oldest
            row = self._rows.pop(victim)
            del self._digests[victim]
            self._ref.pop(victim, None)
            self.evictions_total += 1
        else:
            raise AdapterPoolFullError(
                f"adapter pool full: all {self.max_adapters - 1} "
                "uploadable rows are referenced by live requests")
        for nm in ADAPTER_PROJECTIONS:
            for part in ("a", "b"):
                self.pool[nm][part][row].copy_(
                    torch.from_numpy(clean[nm][part]))
        self._rows[adapter_id] = row
        self._digests[adapter_id] = self._digest(clean)
        self._ref[adapter_id] = 0
        self._lru[adapter_id] = None                     # MRU end
        self.uploads_total += 1
        return row

    def evict(self, adapter_id: int) -> None:
        """Explicitly drop a resident adapter, freeing its row. Refused
        (typed) while any live slot references the id — exactly the
        block allocator's rule that a referenced block never leaves
        the arena."""
        if adapter_id == 0:
            raise AdapterError(
                "adapter 0 is the reserved base identity and cannot "
                "be evicted")
        if adapter_id not in self._rows:
            raise UnknownAdapterError(
                f"adapter {adapter_id} is not resident "
                f"(resident: {sorted(self._rows)})")
        if self._ref.get(adapter_id, 0) > 0:
            raise AdapterReferencedError(
                f"adapter {adapter_id} is referenced by "
                f"{self._ref[adapter_id]} live request(s); evict "
                "refused")
        row = self._rows.pop(adapter_id)
        del self._digests[adapter_id]
        self._ref.pop(adapter_id, None)
        self._lru.pop(adapter_id, None)
        self._free_rows.append(row)
        self.evictions_total += 1

    # -- request lifecycle refcounts ----------------------------------------

    def acquire(self, adapter_id: int) -> None:
        """Pin `adapter_id` for one request's lifetime (id 0 is a no-op
        — the identity needs no pin). Raises UnknownAdapterError for a
        non-resident id: THE typed 4xx the admission door maps a
        tenant's unknown adapter onto."""
        if adapter_id == 0:
            return
        if adapter_id not in self._rows:
            raise UnknownAdapterError(
                f"adapter {adapter_id} is not resident "
                f"(resident: {sorted(self._rows)})")
        self._ref[adapter_id] = self._ref.get(adapter_id, 0) + 1
        if self._ref[adapter_id] == 1:
            self._lru.pop(adapter_id, None)   # no longer evictable

    def release(self, adapter_id: int) -> None:
        """Drop one request's pin; the last release makes the id
        LRU-evictable again (MRU end — a just-finished adapter is the
        likeliest to be requested next)."""
        if adapter_id == 0:
            return
        if self._ref.get(adapter_id, 0) <= 0:
            raise AdapterError(
                f"refcount underflow on adapter {adapter_id}")
        self._ref[adapter_id] -= 1
        if self._ref[adapter_id] == 0:
            self._lru[adapter_id] = None

    def refcount(self, adapter_id: int) -> int:
        return 0 if adapter_id == 0 else self._ref.get(adapter_id, 0)

    # -- introspection -------------------------------------------------------

    def row_of(self, adapter_id: int) -> int:
        """The pool row the decode carry gathers for `adapter_id` — what
        admission stamps into the per-slot adapter-row vector."""
        if adapter_id == 0:
            return 0
        if adapter_id not in self._rows:
            raise UnknownAdapterError(
                f"adapter {adapter_id} is not resident "
                f"(resident: {sorted(self._rows)})")
        return self._rows[adapter_id]

    def is_resident(self, adapter_id: int) -> bool:
        return adapter_id in self._rows

    @property
    def resident(self) -> Tuple[int, ...]:
        """Resident UPLOADED adapter ids (the identity 0 excluded) —
        what /healthz rows and the adapters_resident gauge report."""
        return tuple(sorted(i for i in self._rows if i != 0))

    @property
    def resident_count(self) -> int:
        return len(self._rows) - 1

    @property
    def pool_bytes(self) -> int:
        """Whole-pool HBM footprint, constant for the engine's life
        (uploads update values at fixed shape)."""
        return self._pool_bytes

    def occupancy(self) -> Dict[str, object]:
        return {"max_adapters": self.max_adapters,
                "adapter_rank": self.rank,
                "adapters_resident": self.resident_count,
                "adapter_pool_bytes": self.pool_bytes,
                "adapter_uploads": self.uploads_total,
                "adapter_evictions": self.evictions_total}
