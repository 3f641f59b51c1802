"""Multi-tenant LoRA adapters in the PyTorch port (`paddle_tpu_torch.
serving.adapters`, `ServingConfig(max_adapters=, adapter_rank=)`, the
per-slot gather-matmul of `models.gpt_decode._dense_a`) against the JAX
package's, on the CPU, on the tiny GPT of tests/test_adapters.py (vocab
97, hidden 32, 2 layers, 2 slots, buckets 4 and 8, max_len 32, rank 2).
Mirrors tests/test_adapters.py without a mesh:

  * make_adapter's bytes and the pool's content digests are JAX's bit
    for bit;
  * config, upload-geometry and pool refcount/LRU disciplines, each
    failure a typed AdapterError (a ValueError); an unknown adapter id
    at the submit door;
  * adapter_id=0 streams equal an adapterless engine's bitwise, with
    speculation on and off and an fp32 or int8 arena, through
    preemption, with the same family events;
  * co-batched adapters: greedy and seeded streams equal the JAX
    engine's at decode_chunk 8 and 4, overlap on and off, with
    speculate_k > 0 and through preemption; each equals a dedicated
    single-adapter engine's;
  * an adapter ticket crosses packages both ways; no pool, not resident
    and content-mismatch rejects;
  * the serving_adapter* families exist only on adapter engines, roll
    up into /varz, and the request log stamps adapter ids.

Where a port stream differs from JAX's, `_same_or_near_tie` requires the
first differing token to be a near-tie (top-2 margin under 1e-5) in
JAX's own scores, taken through JAX's paged prefill under the same
adapter.
"""

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import gpt_decode as gd
from paddle_tpu.models.gpt import GPTConfig, gpt_lm_program
from paddle_tpu.serving import AdapterPool as JAdapterPool
from paddle_tpu.serving import MigrationTicket as JMigrationTicket
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import make_adapter as jmake_adapter
from paddle_tpu_torch.models import gpt_decode as tgd
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.serving import (AdapterError, AdapterGeometryError,
                                      AdapterPool, AdapterPoolFullError,
                                      AdapterReferencedError,
                                      MigrationTicket, ServingConfig,
                                      ServingEngine, TicketError,
                                      UnknownAdapterError, make_adapter)
from test_torch_serving import _close_engines, _opened  # noqa: F401
from torch_port_common import one_torch_thread  # noqa: F401


TIE = 1e-5
RANK = 2
IDS = [1, 2, 3, 0, 1, 2, 3, 0]
PRESSURE = dict(num_slots=4, block_size=4, kv_blocks=12, decode_chunk=4,
                preempt=True)


def _cfg(mod):
    return mod(vocab_size=97, hidden=32, layers=2, heads=4, max_pos=64,
               dropout=0.0, attn_impl="xla")


_RNG = np.random.RandomState(2)
MIX = [_RNG.randint(0, 97, (3 + i % 4,)).astype(np.int32)
       for i in range(len(IDS))]


def _mix_kw(i):
    return {"temperature": 0.8 if i % 2 else 0.0, "seed": i}


@pytest.fixture(scope="module")
def world():
    cfg = _cfg(GPTConfig)
    with pt.unique_name_guard():
        main, startup, _ = gpt_lm_program(cfg, 8, is_test=True)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor().run(startup)
        jp = gd.collect_gpt_params(scope, cfg)
    arrays = {v.name: np.asarray(scope.find_var(v.name))
              for v in main.list_vars() if v.persistable
              and scope.find_var(v.name) is not None}
    tscope = ptt.Scope()
    ptt.io.set_params_from_numpy(tscope, arrays, "cpu")
    tcfg = _cfg(TGPTConfig)
    return {"cfg": cfg, "jp": jp, "tcfg": tcfg,
            "tp": tgd.collect_gpt_params(tscope, tcfg), "refs": {}}


def _kw(kw, adapters):
    kw = dict(kw)
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_queue", 16)
    kw.setdefault("prefill_buckets", (4, 8))
    kw.setdefault("max_len", 32)
    if adapters:
        kw.setdefault("max_adapters", 4)
        kw.setdefault("adapter_rank", RANK)
    return kw


def make_engine(world, adapters=True, upload=(), **kw):
    eng = _opened(ServingEngine(world["tp"], world["tcfg"],
                                ServingConfig(**_kw(kw, adapters))))
    for aid in upload:
        eng.upload_adapter(aid, make_adapter(world["tcfg"], RANK, aid))
    return eng


def make_jax_engine(world, adapters=True, upload=(), **kw):
    eng = _opened(JServingEngine(world["jp"], world["cfg"],
                                 JServingConfig(**_kw(kw, adapters))))
    for aid in upload:
        eng.upload_adapter(aid, jmake_adapter(world["cfg"], RANK, aid))
    return eng


def _run_mix(eng, ids=IDS, max_new=8):
    reqs = [eng.submit(p, max_new, adapter_id=aid, **_mix_kw(i))
            for i, (p, aid) in enumerate(zip(MIX, ids))]
    eng.run_until_drained()
    return [r.output() for r in reqs]


def jax_ref(world, **kw):
    """The JAX engine's streams of the co-batched mix (memoized)."""
    key = tuple(sorted(kw.items()))
    if key not in world["refs"]:
        eng = make_jax_engine(world, upload=(1, 2, 3), **kw)
        world["refs"][key] = (_run_mix(eng), eng.scheduler.spec_proposed,
                              eng.scheduler.spec_accepted)
        eng.close()
    return world["refs"][key]


def _jax_scores(world, aid, seq, p_len, i, temperature, seed):
    """JAX's scores for generated token i of `seq` under adapter `aid`:
    the last-position logits of a paged prefill of seq[:p_len + i]
    through a JAX pool holding make_adapter(aid), plus the token's Gumbel
    noise for a seeded draw."""
    import jax.numpy as jnp
    cfg = world["cfg"]
    pool = JAdapterPool(cfg, 4, RANK)
    row = pool.upload(aid, jmake_adapter(cfg, RANK, aid)) if aid else 0
    n = p_len + i
    bs = 4
    pages = -(-n // bs)
    arena = jnp.zeros((cfg.layers, 2, pages + 1, cfg.heads, bs,
                       cfg.hidden // cfg.heads), jnp.float32)
    logits, _ = gd.gpt_prefill_pages(
        world["jp"], cfg, jnp.asarray(seq[None, :n], jnp.int32), 0, n,
        arena, jnp.arange(1, pages + 1, dtype=jnp.int32),
        adapters=pool.pool, adapter_id=jnp.int32(row))
    logits = np.asarray(logits[0])
    if temperature == 0.0:
        return logits
    key = gd.sample_key(np.uint32(seed))
    for _ in range(i):
        key = gd.sample_split(key)
    scaled = logits / np.float32(temperature)
    return scaled + np.asarray(gd.sample_gumbel(jnp.asarray(key),
                                                scaled.size))


def _same_or_near_tie(world, aid, jax_out, port_out, p_len,
                      temperature=0.0, seed=0, name=""):
    jax_out, port_out = np.asarray(jax_out), np.asarray(port_out)
    assert jax_out.shape == port_out.shape, name
    diff = np.nonzero(jax_out != port_out)[0]
    if not diff.size:
        return
    i = int(diff[0]) - p_len
    assert i >= 0, f"{name}: prompt differs"
    s = np.sort(_jax_scores(world, aid, jax_out, p_len, i, temperature,
                            seed))[::-1]
    assert s[0] - s[1] < TIE, (
        f"{name}: stream differs from JAX's at generated token {i} "
        f"(margin {s[0] - s[1]} is no near-tie)")


def _hold_to_jax(world, refs, outs, name):
    for i, (p, aid, a, b) in enumerate(zip(MIX, IDS, refs, outs)):
        _same_or_near_tie(world, aid, a, b, p.size,
                          name=f"{name}[{i}] adapter {aid}", **_mix_kw(i))


def _drive(eng, req, n=2):
    while len(req.tokens) < n:
        eng.step()
    assert not req.finished


# -- bytes and digests --------------------------------------------------------

@pytest.mark.parametrize("rank,seed", [(1, 0), (2, 7), (8, 123)])
def test_make_adapter_bytes_and_digest_bitwise(world, rank, seed):
    """make_adapter(cfg, rank, seed) is JAX's array for array, and the
    content digest a pool commits at upload is JAX's byte for byte."""
    ta = make_adapter(world["tcfg"], rank, seed)
    ja = jmake_adapter(world["cfg"], rank, seed)
    for nm in tgd.ADAPTER_PROJECTIONS:
        for part in ("a", "b"):
            assert ta[nm][part].dtype == np.float32
            np.testing.assert_array_equal(ta[nm][part], ja[nm][part])
    tp = AdapterPool(world["tcfg"], 3, rank)
    jp = JAdapterPool(world["cfg"], 3, rank)
    tp.upload(5, ta)
    jp.upload(5, ja)
    assert tp.digest_of(5) == jp.digest_of(5) and len(tp.digest_of(5)) == 16
    assert tp.pool_bytes == jp.pool_bytes
    assert tp.digest_of(0) == b""


# -- the typed front doors ----------------------------------------------------

def test_servingconfig_adapter_validation(world):
    """Both knobs or neither, max_adapters >= 2, adapter_rank >= 1, bools
    refused, all at config time; an adapter id on an adapterless engine,
    or a negative one, is refused at submit."""
    with pytest.raises(ValueError, match="adapter_rank"):
        ServingConfig(max_adapters=4)
    with pytest.raises(ValueError, match="max_adapters"):
        ServingConfig(adapter_rank=2)
    with pytest.raises(ValueError, match="identity"):
        ServingConfig(max_adapters=1, adapter_rank=2)
    with pytest.raises(ValueError, match="max_adapters"):
        ServingConfig(max_adapters=True, adapter_rank=2)
    with pytest.raises(ValueError, match="adapter_rank"):
        ServingConfig(max_adapters=4, adapter_rank=0)
    eng = make_engine(world, adapters=False)
    with pytest.raises(ValueError, match="max_adapters"):
        eng.submit(np.asarray([1, 2, 3], np.int32), 4, adapter_id=1)
    with pytest.raises(ValueError, match="adapter_id"):
        eng.submit(np.asarray([1, 2, 3], np.int32), 4, adapter_id=-1)
    with pytest.raises(ValueError, match="no adapter pool"):
        eng.upload_adapter(1, make_adapter(world["tcfg"], RANK, 1))
    eng.close()


def test_upload_geometry_validation(world):
    """Wrong rank, wrong width, missing projections and id 0 are typed
    AdapterGeometryErrors, and leave the pool untouched; an upload is an
    indexed copy into the same pool tensors."""
    cfg = world["tcfg"]
    eng = make_engine(world)
    pool = {nm: (eng.adapters.pool[nm]["a"].data_ptr(),
                 eng.adapters.pool[nm]["b"].data_ptr())
            for nm in tgd.ADAPTER_PROJECTIONS}
    good = make_adapter(cfg, RANK, seed=1)
    row = eng.upload_adapter(1, good)
    assert row >= 1
    np.testing.assert_array_equal(
        eng.adapters.pool["mlp2"]["b"][row].numpy(), good["mlp2"]["b"])
    assert (eng.adapters.pool["q"]["a"][0] == 0).all()
    with pytest.raises(AdapterGeometryError, match="rank"):
        eng.upload_adapter(2, make_adapter(cfg, RANK + 1, seed=2))
    bad_width = make_adapter(cfg, RANK, seed=2)
    bad_width["q"]["a"] = bad_width["q"]["a"][:, :-1]
    with pytest.raises(AdapterGeometryError, match="geometry"):
        eng.upload_adapter(2, bad_width)
    with pytest.raises(AdapterGeometryError, match="missing"):
        eng.upload_adapter(2, {"q": good["q"]})
    with pytest.raises(AdapterGeometryError, match="identity"):
        eng.upload_adapter(0, good)
    assert isinstance(AdapterGeometryError("x"), ValueError)
    assert eng.adapters.resident == (1,)
    assert pool == {nm: (eng.adapters.pool[nm]["a"].data_ptr(),
                         eng.adapters.pool[nm]["b"].data_ptr())
                    for nm in tgd.ADAPTER_PROJECTIONS}
    eng.close()


def test_pool_refcount_lru_discipline(world):
    """Evict and re-upload refused while referenced, pressure evicts the
    OLDEST unreferenced id, a pool whose every row is pinned refuses a
    new id with the typed pool-full error; the identity and unknown ids
    are typed refusals."""
    cfg = world["tcfg"]
    pool = AdapterPool(cfg, max_adapters=4, rank=RANK)    # 3 usable rows
    for aid in (1, 2, 3):
        pool.upload(aid, make_adapter(cfg, RANK, seed=aid))
    assert pool.resident == (1, 2, 3)
    pool.acquire(1)
    with pytest.raises(AdapterReferencedError, match="evict"):
        pool.evict(1)
    with pytest.raises(AdapterReferencedError, match="re-upload"):
        pool.upload(1, make_adapter(cfg, RANK, seed=9))
    pool.upload(4, make_adapter(cfg, RANK, seed=4))
    assert pool.resident == (1, 3, 4) and pool.evictions_total == 1
    pool.acquire(3)
    pool.acquire(4)
    with pytest.raises(AdapterPoolFullError, match="full"):
        pool.upload(5, make_adapter(cfg, RANK, seed=5))
    pool.release(1)
    pool.evict(1)
    assert not pool.is_resident(1)
    pool.upload(5, make_adapter(cfg, RANK, seed=5))
    assert pool.resident == (3, 4, 5)
    with pytest.raises(UnknownAdapterError):
        pool.evict(77)
    with pytest.raises(AdapterError, match="identity"):
        pool.evict(0)
    with pytest.raises(UnknownAdapterError):
        pool.row_of(77)
    with pytest.raises(AdapterError, match="underflow"):
        pool.release(5)
    for cls in (AdapterError, UnknownAdapterError, AdapterPoolFullError,
                AdapterReferencedError):
        assert issubclass(cls, ValueError)


def test_unknown_adapter_typed_error_at_submit(world):
    """An adapter nobody uploaded is UnknownAdapterError at submit, counts
    as no submission and leaks nothing: the next request serves."""
    eng = make_engine(world)
    with pytest.raises(UnknownAdapterError, match="not resident"):
        eng.submit(np.asarray([1, 2, 3], np.int32), 4, adapter_id=9)
    assert eng.stats()["submitted"] == 0
    req = eng.submit(np.asarray([1, 2, 3], np.int32), 4)
    eng.run_until_drained()
    assert req.state == "finished"
    s = eng.stats()
    assert s["blocks_used"] == 0 and s["adapters_resident"] == 0
    eng.close()


# -- identity: adapter_id=0 == adapterless -----------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("k", [0, 3])
def test_adapter0_identity_matrix(world, k, kv_dtype):
    """An adapter-pool engine (one adapter resident, never routed) driving
    every request at adapter_id=0 emits bitwise the adapterless engine's
    greedy and seeded streams, speculation on and off, fp32 and int8
    arena, with the same family events and the same decode carry
    length plus one."""
    kw = dict(speculate_k=k, kv_dtype=kv_dtype, max_len=48)
    base = make_engine(world, adapters=False, **kw)
    ref = _run_mix(base, ids=[0] * len(IDS))
    eng = make_engine(world, upload=(1,), **kw)
    got = _run_mix(eng, ids=[0] * len(IDS))
    assert [list(o) for o in got] == [list(o) for o in ref], (k, kv_dtype)
    assert eng.scheduler.compile_events == base.scheduler.compile_events
    assert len(eng.scheduler._state) == len(base.scheduler._state) + 1
    base.close()
    eng.close()


def test_adapter0_identity_through_preempt_resume(world):
    """All requests at id 0 through an arena that must preempt: bitwise
    the unpressured adapterless run, and the drain leaks nothing."""
    ids = [0] * 4
    ref = make_engine(world, adapters=False, num_slots=4, block_size=4,
                      decode_chunk=4)
    refs = _run_mix(ref, ids=ids, max_new=12)
    eng = make_engine(world, upload=(1,), **PRESSURE)
    got = _run_mix(eng, ids=ids, max_new=12)
    assert eng.stats()["preemptions"] >= 1
    assert [list(o) for o in got] == [list(o) for o in refs]
    assert eng.stats()["blocks_used"] == 0


# -- co-batched adapters against the JAX engine -------------------------------

@pytest.mark.parametrize("chunk,overlap", [(8, True), (8, False),
                                           (4, True), (4, False)])
def test_cobatched_adapters_match_jax(world, chunk, overlap):
    """Three adapters plus the identity co-batched on 2 slots (requests
    queue, slots churn): greedy and seeded streams equal the JAX
    engine's, at each chunk size, overlap on and off; the family count
    stays len(buckets) + 2."""
    refs, _, _ = jax_ref(world)
    eng = make_engine(world, upload=(1, 2, 3), decode_chunk=chunk,
                      overlap=overlap)
    outs = _run_mix(eng)
    _hold_to_jax(world, refs, outs, f"k{chunk} overlap={overlap}")
    events = eng.scheduler.compile_events
    assert events.count("decode_chunk") == 1
    assert len(events) <= len(eng.buckets) + 2
    s = eng.stats()
    assert s["adapters_resident"] == 3 and s["adapter_uploads"] == 3
    assert all(eng.adapters.refcount(a) == 0 for a in (1, 2, 3))
    eng.close()


def test_cobatched_adapters_spec_match_jax(world):
    """speculate_k = 3 with co-batched adapters (the verify pass's
    low-rank path): the JAX engine's streams and acceptance counts, and
    the port's own k = 0 streams."""
    refs, j_prop, j_acc = jax_ref(world, speculate_k=3)
    eng = make_engine(world, upload=(1, 2, 3), speculate_k=3)
    outs = _run_mix(eng)
    _hold_to_jax(world, refs, outs, "spec")
    assert eng.scheduler.spec_proposed == j_prop > 0
    assert eng.scheduler.spec_accepted == j_acc
    base = _run_mix(make_engine(world, upload=(1, 2, 3)))
    assert [list(o) for o in outs] == [list(o) for o in base]


def test_cobatched_adapters_through_preempt_match_jax(world):
    """Co-batched adapters through an arena that must preempt: swap-in
    re-resolves each sequence's pool row, every stream equals the JAX
    engine's unpressured one, and every pin is released."""
    refs, _, _ = jax_ref(world, num_slots=4, block_size=4,
                         decode_chunk=4)
    eng = make_engine(world, upload=(1, 2, 3), **PRESSURE)
    outs = _run_mix(eng)
    assert eng.stats()["preemptions"] >= 1
    _hold_to_jax(world, refs, outs, "preempt")
    assert eng.stats()["blocks_used"] == 0
    assert all(eng.adapters.refcount(a) == 0 for a in (1, 2, 3))


def test_cobatched_equals_dedicated_engines(world):
    """Each co-batched stream equals a dedicated engine holding only its
    adapter, greedy and seeded; the adapters are genuinely distinct
    (every adapter's greedy stream differs from the identity's)."""
    got = _run_mix(make_engine(world, upload=(1, 2, 3)))
    for aid in (0, 1, 2, 3):
        solo = make_engine(world, upload=(aid,) if aid else ())
        picks = [i for i, a in enumerate(IDS) if a == aid]
        reqs = [solo.submit(MIX[i], 8, adapter_id=aid, **_mix_kw(i))
                for i in picks]
        solo.run_until_drained()
        for i, r in zip(picks, reqs):
            assert list(r.output()) == list(got[i]), (aid, i)
        solo.close()
    greedy = [i for i in range(len(IDS)) if not i % 2]
    base = _run_mix(make_engine(world, adapters=False), ids=[0] * len(IDS))
    assert all(list(got[i]) != list(base[i]) for i in greedy if IDS[i])


# -- migration ----------------------------------------------------------------

def _rewrap(ticket, cls):
    fields = {f: getattr(ticket, f) for f in (
        "prompt", "max_new", "temperature", "seed", "eos_id", "tokens",
        "request_id", "pos", "produced", "seq", "length", "n_blocks",
        "block_size", "payload", "token", "ts", "remaining", "temp", "eos",
        "key_row", "spec", "tenant", "rerouted_from", "slo_stamps",
        "version", "checksum", "created_unix", "mesh_shape", "scales",
        "adapter_id", "adapter_digest")}
    return cls(**fields)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("temp,seed", [(0.0, 0), (0.8, 3)])
def test_adapter_ticket_crosses_packages(world, direction, temp, seed):
    """An adapter-2 sequence migrates between the packages: the ticket
    carries (2, the content digest), verifies under the other class with
    the sender's checksum, the source releases its pin and the target
    holds one until the stream finishes as the receiver's never-migrated
    run does."""
    p = np.asarray([3, 1, 4, 1, 5], np.int32)
    mk_src, mk_dst, cls = (make_engine, make_jax_engine, JMigrationTicket) \
        if direction == "port_to_jax" \
        else (make_jax_engine, make_engine, MigrationTicket)
    src = mk_src(world, upload=(2,), decode_chunk=4, max_len=48)
    dst = mk_dst(world, upload=(2,), decode_chunk=4, max_len=48)
    stream = []
    req = src.submit(p, 30, temperature=temp, seed=seed, adapter_id=2,
                     on_token=lambda r, t: stream.append(t))
    _drive(src, req)
    t = src.migrate_out(req)
    assert t.adapter_id == 2 and t.adapter_digest == \
        src.adapters.digest_of(2)
    assert src.adapters.refcount(2) == 0
    ticket = _rewrap(t, cls)
    assert ticket.verify() and ticket.checksum == t.checksum
    req2 = dst.migrate_in(ticket, on_token=lambda r, t: stream.append(t))
    assert dst.adapters.refcount(2) == 1
    src.run_until_drained()
    dst.run_until_drained()
    assert req2.state == "finished" and len(stream) == 30
    assert dst.adapters.refcount(2) == 0
    ref = mk_dst(world, upload=(2,), decode_chunk=4, max_len=48)
    full = []
    ref.submit(p, 30, temperature=temp, seed=seed, adapter_id=2,
               on_token=lambda r, t: full.append(t))
    ref.run_until_drained()
    jax_full = full if direction == "port_to_jax" else stream
    port_full = stream if direction == "port_to_jax" else full
    _same_or_near_tie(world, 2, np.concatenate([p, jax_full]),
                      np.concatenate([p, port_full]), p.size, temp, seed,
                      name=direction)


def test_adapter_ticket_rejects(world):
    """TicketErrors with nothing mutated on the refusing engine: a
    target with no pool, one without the id, one holding different bytes
    under it, a JAX ticket onto a port pool of other bytes; a tampered
    payload fails the checksum; the intact ticket still adopts."""
    p = np.asarray([5, 7, 11], np.int32)
    src = make_engine(world, upload=(2,), decode_chunk=4, max_len=48)
    req = src.submit(p, 20, adapter_id=2)
    _drive(src, req)
    ticket = src.migrate_out(req)
    no_pool = make_engine(world, adapters=False, decode_chunk=4, max_len=48)
    with pytest.raises(TicketError, match="no adapter pool"):
        no_pool.migrate_in(ticket)
    missing = make_engine(world, decode_chunk=4, max_len=48)
    with pytest.raises(TicketError, match="not resident"):
        missing.migrate_in(ticket)
    different = make_engine(world, decode_chunk=4, max_len=48)
    different.upload_adapter(2, make_adapter(world["tcfg"], RANK, 99))
    with pytest.raises(TicketError, match="mismatch"):
        different.migrate_in(ticket)
    js = make_jax_engine(world, decode_chunk=4, max_len=48)
    js.upload_adapter(2, jmake_adapter(world["cfg"], RANK, 99))
    jr = js.submit(p, 20, adapter_id=2)
    _drive(js, jr)
    jt = _rewrap(js.migrate_out(jr), MigrationTicket)
    ok = make_engine(world, upload=(2,), decode_chunk=4, max_len=48)
    with pytest.raises(TicketError, match="mismatch"):
        ok.migrate_in(jt)
    for eng in (no_pool, missing, different, ok):
        s = eng.stats()
        assert s["swapped_slots"] == 0 and s["blocks_used"] == 0
    good = ticket.payload
    ticket.payload = good.copy()
    ticket.payload[0, 0, 0, 0, 0, 0] += 1.0
    with pytest.raises(TicketError, match="checksum"):
        ok.migrate_in(ticket)
    ticket.payload = good
    req2 = ok.migrate_in(ticket)
    ok.run_until_drained()
    assert req2.state == "finished" and len(req2.tokens) == 20


# -- observability ------------------------------------------------------------

def test_adapter_metric_families_and_varz_rollup(world):
    """The four serving_adapter* families exist only on adapter engines,
    carry upload/evict truth into /varz's "adapters" block (absent with
    no adapter engine), and leave with close()."""
    from paddle_tpu_torch.observability import get_registry
    from paddle_tpu_torch.observability.debug_server import _serving_varz
    plain = make_engine(world, adapters=False)
    label = plain.stats()["engine_label"]
    snap = get_registry().snapshot()
    assert not any(r["labels"].get("engine") == label
                   for r in snap.get("serving_adapters_resident",
                                     {}).get("series", []))
    assert label not in _serving_varz(snap).get("adapters", {})
    plain.close()
    eng = make_engine(world)
    label = eng.stats()["engine_label"]
    eng.upload_adapter(1, make_adapter(world["tcfg"], RANK, 1))
    eng.upload_adapter(2, make_adapter(world["tcfg"], RANK, 2))
    eng.evict_adapter(2)
    varz = _serving_varz(get_registry().snapshot())["adapters"][label]
    assert varz == {"adapters_resident": 1,
                    "adapter_pool_bytes": eng.adapters.pool_bytes,
                    "adapter_uploads": 2, "adapter_evictions": 1}
    eng.close()
    snap = get_registry().snapshot()
    assert not any(r["labels"].get("engine") == label
                   for r in snap.get("serving_adapters_resident",
                                     {}).get("series", []))


def test_adapter_request_log_stamps(world):
    """submitted, admitted, migrate_out and migrate_in stamp the adapter
    id; the pool lifecycle journals adapter_upload / adapter_evict."""
    from paddle_tpu_torch.observability import request_log as rl
    with rl.request_logging() as log:
        src = make_engine(world, upload=(3,), decode_chunk=4, max_len=48)
        dst = make_engine(world, upload=(3,), decode_chunk=4, max_len=48)
        req = src.submit(np.asarray([2, 7, 1], np.int32), 20,
                         adapter_id=3)
        _drive(src, req)
        req2 = dst.migrate_in(src.migrate_out(req))
        src.run_until_drained()
        dst.run_until_drained()
        dst.evict_adapter(3)
        assert req2.state == "finished"
    by_kind = {}
    for e in log.recent():
        by_kind.setdefault(e["kind"], []).append(e)
    assert [e["adapter_id"] for e in by_kind["adapter_upload"]] == [3, 3]
    assert [e["adapter_id"] for e in by_kind["adapter_evict"]] == [3]
    for kind in ("submitted", "admitted", "migrate_out", "migrate_in"):
        assert any(e.get("adapter_id") == 3 for e in by_kind[kind]), kind


def test_engine_stats_surface_and_cancel_release(world):
    """stats() carries the pool's occupancy (absent on an adapterless
    engine) and upload/evict move it synchronously; a cancelled request
    releases its pin, running or queued."""
    eng = make_engine(world)
    s = eng.stats()
    assert s["max_adapters"] == 4 and s["adapter_rank"] == RANK
    assert s["adapter_pool_bytes"] == eng.adapters.pool_bytes > 0
    eng.upload_adapter(1, make_adapter(world["tcfg"], RANK, 1))
    assert eng.stats()["adapters_resident"] == 1
    assert eng.metrics.adapters_resident == 1
    running = eng.submit(MIX[0], 20, adapter_id=1)
    queued = [eng.submit(MIX[i], 20, adapter_id=1) for i in (1, 2)]
    _drive(eng, running)
    assert eng.adapters.refcount(1) == 3
    for r in [running] + queued:
        assert eng.cancel(r)
    assert eng.adapters.refcount(1) == 0
    eng.run_until_drained()
    eng.evict_adapter(1)
    s = eng.stats()
    assert s["adapters_resident"] == 0 and s["adapter_evictions"] == 1
    assert s["blocks_used"] == 0
    plain = make_engine(world, adapters=False)
    assert "adapters_resident" not in plain.stats()
    plain.close()
    eng.close()


# -- bench_serving --adapters -------------------------------------------------

def test_bench_serving_adapters_rows():
    """paddle_tpu_torch.tools.bench_serving --adapters on the tiny model:
    a row for 1 and for 3 co-batched adapters with the registry's pool
    columns; the pool's bytes equal JAX's pool at the bench's geometry
    and do not move with residency; determinism and isolation asserted
    inside the workload. No tokens/s ratio is asserted."""
    from paddle_tpu_torch.tools import bench_serving
    rows = bench_serving.run_adapters("tiny", n_adapters=3, requests=6,
                                      max_new=16, device="cpu")
    by_pop = {int(r["metric"].rsplit("_", 1)[1]): r["extra"]
              for r in rows}
    assert set(by_pop) == {1, 3}
    cfg = GPTConfig(**bench_serving.MODELS["tiny"][0])
    want = JAdapterPool(cfg, 4, 4).pool_bytes
    for n, e in by_pop.items():
        assert e["completed"] == 6 and e["n_adapters"] == n
        assert e["adapters_resident"] == n == e["adapter_uploads"]
        assert e["adapter_evictions"] == 0
        assert e["adapter_pool_bytes"] == want
        assert e["streams_deterministic"] is True
        assert e["compiled_executables"] <= 2 + 2
    assert by_pop[3]["streams_isolated"] is True
