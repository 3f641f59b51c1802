"""Live cross-replica sequence migration: the portable handoff record.

A copy of `paddle_tpu/serving/migration.py` (pure numpy). The ticket's
fields, dtypes and digest are the JAX package's byte for byte, so a
ticket extracted by either package's engine adopts into the other's:
the port's `SwappedSequence` converts its torch rows to JAX's numpy
dtypes at the boundary (int32 carry rows, a float32 temperature, a
uint32 key row), and the quantized-scale and adapter fields stay in the
digest at their "absent" bytes. `_check_geometry` reads the port's
arena through `kv.kv.dtype` / `kv.kv.shape`.

Host-swap preemption already serializes a RUNNING sequence
completely — `SwappedSequence` holds the slot's KV arena blocks, page
geometry, decode carry (current token, position, budget, temperature,
PRNG key) and the speculative drafter rows — but the record was bound
to the engine that produced it (it carries the engine's live
`GenerationRequest`). This module generalizes it into an
ENGINE-INDEPENDENT `MigrationTicket` the router can hand between
replicas: the reference's trainer/pserver work-redistribution story
(PAPER.md layer map) applied to inference, so a hot replica's parked
and running sequences can REBALANCE onto an idle neighbor instead of
only failing over when a replica dies.

A ticket wraps the serialized sequence state plus the stream
bookkeeping a new engine needs to continue the SAME client stream:

* request parameters (prompt, max_new, temperature, seed, eos_id) —
  what a fresh `submit()` would have taken;
* the emitted-token prefix (ids, in order) so the adopting engine's
  `GenerationRequest` resumes with `len(tokens)` already delivered and
  the budget math (`produced` vs `max_new`) lands on the exact same
  finish token;
* the sequence state rows of `SwappedSequence` (KV payload, page
  count, decode carry, PRNG key row, drafter rows) with their EXACT
  numpy dtypes — the adopting engine's `swap_in` family sees the same
  inputs the preemption path feeds it, so migration adds no family;
* annotations for the journal/router (source request id, tenant, SLO
  stamps, the `rerouted_from` hop chain).

Integrity: `checksum` is a blake2b over every sequence-critical field
(versioned header, request parameters, emitted prefix, payload bytes,
carry rows). `verify()` recomputes it; `validate_for(engine)` verifies
AND checks the target's geometry (block size, arena dtype, per-block
shape, page capacity, speculation config) — a ticket no peer can host
fails fast with `TicketError` and the router falls back to
failover semantics. Router-side annotations (tenant, stamps, hop
chain) ride OUTSIDE the checksum: they are bookkeeping, not sequence
state, and the router amends them after extraction.

Token-stream identity across a migration is the same property
preemption pinned: the serving sampler is a slot-independent
counter-based threefry (scheduler._sample_row), so the restored key
row continues the per-token split chain bit-exactly wherever — and on
whichever replica — the sequence resumes.

MESH PORTABILITY: tickets always carry the canonical FULL-HEAD host
layout — a tensor-parallel source engine's swap-out device_get
assembles the per-chip head shards before anything is ticketed — so a
sequence extracted on a tp=2 replica lands on a tp=4 or single-chip
peer and vice versa (`mesh_shape` rides along as an annotation).
`validate_for` rejects, with TicketError instead of a crash, any
payload whose head count is a per-chip shard rather than the full
layout (the corrupted-shard case).
"""

from __future__ import annotations

import hashlib
import struct
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .scheduler import SwappedSequence, host_dtype

__all__ = ["MigrationTicket", "MigrationError", "TicketError",
           "TICKET_VERSION"]

# version 2: the digest layout grew the quantized-KV scale plane (a
# presence byte + dtype/shape/bytes when present). Bumped so a v1
# ticket meeting new code — a rolling upgrade with old- and new-code
# replicas coexisting — refuses as a typed VERSION mismatch instead of
# being misdiagnosed as payload corruption by the checksum compare.
# version 3: the digest grew the sequence's adapter identity —
# (adapter_id, content digest of the adapter's A/B bytes at extraction)
# — so a multi-tenant sequence can never silently resume against the
# WRONG adapter (a different tenant's weights under a recycled id, or
# the base model on a pool that never saw the upload). Same rolling-
# upgrade rationale for the bump.
TICKET_VERSION = 3


class MigrationError(RuntimeError):
    """A migration step was refused or could not proceed (engine
    draining, request not migratable, finished during the fence).
    The sequence is left exactly where it was — refusal is always
    clean, never a deadlock or a half-moved stream."""


class TicketError(ValueError):
    """A MigrationTicket failed validation at adoption: corrupted
    payload (checksum mismatch), unknown version, or target-engine
    geometry the sequence cannot occupy (block size / dtype / page
    capacity / speculation mismatch). The ticket is rejected whole —
    nothing was mutated on the refusing engine."""


class MigrationTicket:
    """One serialized sequence in flight between replicas (see module
    doc). Build with `from_swapped()` on the source engine; consume
    with `ServingEngine.migrate_in()`, which calls `validate_for()`
    before touching any state."""

    __slots__ = (
        # header
        "version", "created_unix", "checksum",
        # request parameters (what submit() took)
        "prompt", "max_new", "temperature", "seed", "eos_id",
        # stream bookkeeping
        "tokens", "request_id", "tenant", "rerouted_from", "slo_stamps",
        # sequence state (SwappedSequence minus the engine-bound req)
        "pos", "produced", "seq", "length", "n_blocks", "block_size",
        "payload", "token", "ts", "remaining", "temp", "eos", "key_row",
        "spec", "mesh_shape", "scales", "adapter_id", "adapter_digest",
    )

    def __init__(self, prompt, max_new, temperature, seed, eos_id,
                 tokens, request_id, pos, produced, seq, length,
                 n_blocks, block_size, payload, token, ts, remaining,
                 temp, eos, key_row, spec=None, tenant=None,
                 rerouted_from=(), slo_stamps=None, version=None,
                 checksum=None, created_unix=None, mesh_shape=(1,),
                 scales=None, adapter_id=0, adapter_digest=b""):
        self.version = TICKET_VERSION if version is None else int(version)
        self.created_unix = time.time() if created_unix is None \
            else float(created_unix)
        self.prompt = np.ascontiguousarray(prompt, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.tokens = tuple(int(t) for t in tokens)
        self.request_id = request_id
        self.tenant = tenant
        self.rerouted_from = tuple(rerouted_from)
        self.slo_stamps: Dict[str, Any] = dict(slo_stamps or {})
        self.pos = int(pos)
        self.produced = int(produced)
        self.seq = int(seq)
        self.length = int(length)
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        # numpy dtypes preserved verbatim: the adopting swap_in family
        # sees what the preemption path feeds it
        self.payload = np.asarray(payload)
        # quantized-KV sources: the payload's f32 scale-plane rows
        # ((L, 2, n_blocks, heads, bs)) — sequence state like the
        # payload itself, INSIDE the checksum; None from a
        # full-precision pool
        self.scales = None if scales is None else np.asarray(scales)
        self.token = token
        self.ts = ts
        self.remaining = remaining
        self.temp = temp
        self.eos = eos
        self.key_row = np.asarray(key_row)
        self.spec = spec
        # source-replica mesh geometry, (tp,). An ANNOTATION like the
        # tenant/hop fields (outside the checksum): the payload itself
        # is always the canonical FULL-HEAD host layout — swap_out's
        # device_get assembles the shards — so a ticket from a tp=2
        # replica lands on any geometry-compatible peer, tp or single-
        # chip; the field exists for the journal and for operators
        # tracing which mesh a sequence came off.
        self.mesh_shape = tuple(int(m) for m in mesh_shape)
        # multi-tenant adapter identity: the logical id the sequence was
        # decoding under (0 = base model) plus the CONTENT digest of the
        # adapter's A/B bytes at extraction (AdapterPool.digest_of, b""
        # for the identity). Both inside the checksum — adapter identity
        # is sequence state, not an annotation: resuming a stream under
        # different low-rank weights changes every subsequent token.
        self.adapter_id = int(adapter_id)
        self.adapter_digest = bytes(adapter_digest)
        self.checksum = self._digest() if checksum is None else checksum

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_swapped(cls, sw, block_size: int,
                     mesh_shape=(1,),
                     adapter_digest=b"") -> "MigrationTicket":
        """Wrap a SwappedSequence (engine swap-pool record) into a
        portable ticket. `sw.req` stays behind on the source — the
        ticket carries its parameters and emitted prefix instead.
        `mesh_shape` annotates the SOURCE replica's mesh geometry; the
        payload is already the assembled full-head host layout
        whatever the source mesh was."""
        req = sw.req
        return cls(
            prompt=req.prompt, max_new=sw.max_new,
            temperature=req.temperature, seed=req.seed,
            eos_id=sw.eos_id, tokens=req.tokens,
            request_id=getattr(req, "request_id", None),
            pos=sw.pos, produced=sw.produced, seq=sw.seq,
            length=sw.length, n_blocks=sw.n_blocks,
            block_size=block_size, payload=sw.payload,
            token=sw.token, ts=sw.ts, remaining=sw.remaining,
            temp=sw.temp, eos=sw.eos, key_row=sw.key_row, spec=sw.spec,
            mesh_shape=mesh_shape, scales=sw.scales,
            adapter_id=getattr(sw, "adapter_id", 0),
            adapter_digest=adapter_digest)

    # -- integrity ------------------------------------------------------------

    @property
    def emitted(self) -> int:
        """Tokens already streamed to the client before the handoff."""
        return len(self.tokens)

    @property
    def swap_bytes(self) -> int:
        """Host footprint of the ticket's KV payload (the journal's
        `bytes` field and the transfer-size a scheduler would weigh);
        a quantized payload's scale-plane rows count too."""
        return int(self.payload.nbytes) + (
            int(self.scales.nbytes) if self.scales is not None else 0)

    def _digest(self) -> str:
        """blake2b over every sequence-critical field. Annotations the
        router amends post-extraction (tenant, SLO stamps, hop chain)
        are deliberately OUTSIDE the digest — they are bookkeeping, not
        sequence state."""
        h = hashlib.blake2b(digest_size=16)
        h.update(struct.pack(
            "<9q", self.version, self.pos, self.produced, self.max_new,
            -1 if self.eos_id is None else self.eos_id, self.seq,
            self.length, self.n_blocks, self.block_size))
        h.update(np.float64(self.temperature).tobytes())
        h.update(np.int64(self.seed).tobytes())
        h.update(self.prompt.tobytes())
        h.update(np.asarray(self.tokens, np.int64).tobytes())
        h.update(str(self.payload.dtype).encode())
        h.update(np.asarray(self.payload.shape, np.int64).tobytes())
        h.update(np.ascontiguousarray(self.payload).tobytes())
        # the scale plane is sequence state exactly like the int8 rows
        # it dequantizes (a corrupted scale silently rescales every
        # value in its row), so the dtype/shape/bytes — and its very
        # presence — commit to the digest
        if self.scales is None:
            h.update(b"\x00")
        else:
            h.update(b"\x01")
            h.update(str(self.scales.dtype).encode())
            h.update(np.asarray(self.scales.shape, np.int64).tobytes())
            h.update(np.ascontiguousarray(self.scales).tobytes())
        h.update(np.ascontiguousarray(self.key_row).tobytes())
        for row in (self.token, self.ts, self.remaining, self.temp,
                    self.eos):
            h.update(np.asarray(row).tobytes())
        if self.spec is not None:
            for row in self.spec:
                h.update(np.ascontiguousarray(np.asarray(row)).tobytes())
        # adapter identity: the id AND the adapter-content digest commit
        # (presence-byte pattern, like the scale plane) — a tampered id
        # or a swapped-out adapter body both surface as checksum
        # mismatch, before the digest-vs-target-pool compare even runs
        h.update(np.int64(self.adapter_id).tobytes())
        if self.adapter_digest:
            h.update(b"\x01")
            h.update(self.adapter_digest)
        else:
            h.update(b"\x00")
        return h.hexdigest()

    def verify(self) -> bool:
        """True when the checksum still matches the sequence state."""
        return self.checksum == self._digest()

    # -- target-engine compatibility ------------------------------------------

    def validate_for(self, engine) -> None:
        """Raise TicketError unless `engine` can host this sequence:
        checksum intact, version known, per-block KV geometry and dtype
        identical, page/position capacity sufficient, speculation
        config matching. Called once, at adoption (migrate_in) — the
        payload digest walks every KV byte, so it must not run per
        candidate target; the router pre-screens with the geometry-only
        `compatible()` instead."""
        if not self.verify():
            raise TicketError(
                f"ticket checksum mismatch for request "
                f"{self.request_id!r} — payload corrupted in transfer")
        self._check_geometry(engine)

    def _check_geometry(self, engine) -> None:
        """The digest-free half of validate_for: version + target-engine
        geometry. Read-only over immutable engine attributes (and
        abstract dtype/shape only), so it is safe cross-thread."""
        if self.version != TICKET_VERSION:
            raise TicketError(
                f"ticket version {self.version} != supported "
                f"{TICKET_VERSION}")
        kv = engine.kv
        if self.block_size != kv.block_size:
            raise TicketError(
                f"block_size mismatch: ticket {self.block_size}, "
                f"engine {kv.block_size}")
        # dtype/shape reads only: no value of the arena is touched, so
        # this is safe from any thread
        want = host_dtype(kv.kv.dtype)
        if self.payload.dtype != want:
            # quantization geometry is part of the pool's identity: an
            # fp32 sequence cannot land in an int8 arena (or vice
            # versa) — the refusal must be typed, never a scatter
            # crash or a silent re-dtype
            raise TicketError(
                f"KV dtype mismatch: ticket payload {self.payload.dtype}"
                f", engine kv_dtype {want} — a "
                f"{'quantized' if want == np.int8 else 'full-precision'}"
                " pool only adopts sequences serialized in its own "
                "storage dtype")
        shape = self.payload.shape
        arena = tuple(kv.kv.shape)  # (L, 2, num_blocks, heads, bs, hd)
        if len(shape) != 6:
            # a malformed/truncated payload must reject cleanly, never
            # crash an index below or the adopting swap_in scatter
            raise TicketError(
                f"ticket payload rank {len(shape)} != 6 — not a KV "
                "block payload (layers, 2, blocks, heads, bs, hd)")
        if shape[3] != arena[3]:
            # MESH GEOMETRY: tickets always carry the canonical FULL-
            # HEAD host layout (swap_out's device_get assembles the
            # per-chip shards), so ANY head-count mismatch means the
            # payload is a raw per-chip shard — or a different model —
            # and no page-row scatter could ever place it soundly
            raise TicketError(
                f"KV mesh/head geometry mismatch: ticket payload "
                f"carries {shape[3]} heads (source mesh "
                f"{self.mesh_shape}), engine serves {arena[3]} heads "
                f"(mesh {tuple(kv.mesh_shape)}) — tickets must hold "
                "the assembled full-head layout, not a per-chip shard")
        per_block = (arena[0], arena[1], arena[3], arena[4], arena[5])
        got = (shape[0], shape[1]) + tuple(shape[3:])
        if got != per_block or shape[2] != self.n_blocks:
            raise TicketError(
                f"KV block geometry mismatch: ticket payload {shape} "
                f"({self.n_blocks} blocks), engine per-block "
                f"{per_block}")
        quantized = kv.kv_scales is not None
        if quantized != (self.scales is not None):
            raise TicketError(
                f"KV scale-plane mismatch: ticket "
                f"{'carries' if self.scales is not None else 'lacks'} "
                f"a scale plane, engine kv_dtype {want} "
                f"{'requires' if quantized else 'forbids'} one")
        if self.scales is not None:
            want_s = shape[:5]            # (L, 2, blocks, heads, bs)
            if (self.scales.dtype != np.float32
                    or tuple(self.scales.shape) != want_s):
                raise TicketError(
                    f"KV scale-plane geometry mismatch: ticket scales "
                    f"{self.scales.dtype}{tuple(self.scales.shape)}, "
                    f"expected float32{want_s}")
        if self.n_blocks > kv.max_pages:
            raise TicketError(
                f"sequence holds {self.n_blocks} blocks but the engine "
                f"page table caps at {kv.max_pages}")
        total = self.prompt.size + self.max_new
        if total > kv.max_len:
            raise TicketError(
                f"sequence needs {total} positions but the engine pool "
                f"max_len is {kv.max_len}")
        if kv.blocks_for(total) > kv.blocks_total:
            raise TicketError(
                f"sequence needs {kv.blocks_for(total)} KV blocks but "
                f"the engine arena only has {kv.blocks_total}")
        if self.adapter_id:
            # adapter-aware adoption: the target must HOLD the same
            # adapter — same logical id, same bytes (content digest) —
            # before the sequence may resume under it. Typed refusals
            # for each failure mode; the router's compatible() pre-
            # screen runs these too (digest compare is 16 bytes, not a
            # payload walk).
            pool = getattr(engine, "adapters", None)
            if pool is None:
                raise TicketError(
                    f"sequence decodes under adapter {self.adapter_id} "
                    "but the target engine has no adapter pool "
                    "(ServingConfig(max_adapters=...))")
            if not pool.is_resident(self.adapter_id):
                raise TicketError(
                    f"adapter {self.adapter_id} is not resident on the "
                    f"target pool (resident: {list(pool.resident)}) — "
                    "upload it there before migrating the sequence")
            if pool.digest_of(self.adapter_id) != self.adapter_digest:
                raise TicketError(
                    f"adapter {self.adapter_id} content mismatch: the "
                    "target pool holds DIFFERENT bytes under this id "
                    "than the sequence was decoding against — refusing "
                    "rather than silently switching the stream's "
                    "low-rank weights")
        k = engine.config.speculate_k
        if bool(k) != (self.spec is not None):
            raise TicketError(
                f"speculation mismatch: ticket "
                f"{'carries' if self.spec is not None else 'lacks'} "
                f"drafter state, engine speculate_k={k}")
        if self.spec is not None:
            width = np.asarray(self.spec[1]).shape[-1]
            if width != engine.config.speculate_ngram + 1:
                raise TicketError(
                    f"drafter table width mismatch: ticket {width}, "
                    f"engine {engine.config.speculate_ngram + 1}")

    def compatible(self, engine) -> bool:
        """Non-raising GEOMETRY pre-screen — what the router runs per
        candidate target. Deliberately skips the checksum: the digest
        walks the whole KV payload, corruption is caught exactly once
        at adoption (validate_for inside migrate_in), and an O(replicas)
        full-payload hash per handoff would stretch the very gap the
        client stream is paused for."""
        try:
            self._check_geometry(engine)
            return True
        except TicketError:
            return False

    # -- adoption -------------------------------------------------------------

    def to_swapped(self, req) -> "Any":
        """Rebuild the engine-side swap-pool record around the adopting
        engine's fresh GenerationRequest (caller: migrate_in)."""
        return SwappedSequence(
            req, self.pos, self.produced, self.max_new, self.eos_id,
            self.seq, self.length, self.n_blocks, self.payload,
            self.token, self.ts, self.remaining, self.temp, self.eos,
            self.key_row, self.spec, scales=self.scales,
            adapter_id=self.adapter_id)

    def describe(self) -> Dict[str, Any]:
        """Journal/debug summary (no payload bytes)."""
        return {"version": self.version, "request_id": self.request_id,
                "tenant": self.tenant, "emitted": self.emitted,
                "produced": self.produced, "max_new": self.max_new,
                "n_blocks": self.n_blocks, "bytes": self.swap_bytes,
                "kv_dtype": str(self.payload.dtype),
                "adapter_id": self.adapter_id,
                "mesh_shape": list(self.mesh_shape),
                "rerouted_from": list(self.rerouted_from),
                "checksum": self.checksum}
