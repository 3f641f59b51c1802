"""Host-swap preemption and live migration of the PyTorch port's serving
engine against the JAX package's, on the CPU, on the tiny GPT of
tests/test_torch_serving.py (vocab 97, hidden 32, 2 layers) with its
engine defaults (2 slots, buckets 4 and 8, max_len 32). Mirrors
tests/test_serving.py's preemption and migration tests; every stream is
held token for token against the JAX engine's on the same weights:

  * greedy and seeded streams through an over-subscribed arena that
    must preempt (decode_chunk 1 and 8), under each preempt_policy, equal
    the JAX engine's on the same config and the port's own unpressured
    run; the drain leaks no page, parked record or host byte; the arena
    keeps its storage and a swap never writes the scratch block;
  * a forced page shortage requeues instead of preempting; a drain with
    parked sequences finishes every stream; the request log carries the
    preemption timeline;
  * migrate_out/migrate_in of running and parked sequences, with a
    prefix-cache hit, refusal while draining, ticket integrity;
  * a ticket the JAX engine extracts resumes on the port's engine and
    finishes the stream as JAX's never-migrated run does, and the
    reverse: the swap record's payload layout, dtypes and digest are the
    JAX package's.

Where a port stream differs from JAX's, `_same_or_near_tie` requires the
first differing token to be a near-tie in JAX's own scores (top-2
margin under 1e-5), and the assertion names the stream and position.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import gpt_decode as gd
from paddle_tpu.models.gpt import GPTConfig, gpt_lm_program
from paddle_tpu.serving import MigrationTicket as JMigrationTicket
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch.models import gpt_decode as tgd
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.serving import (FaultPlan, MigrationError,
                                      MigrationTicket, ServingConfig,
                                      ServingEngine, SlotKVCache,
                                      TicketError)
from test_torch_serving import _close_engines, _opened  # noqa: F401
from torch_port_common import one_torch_thread  # noqa: F401


TIE = 1e-5

# over-subscribed arena (tests/test_serving.py's PRESSURE): 4 requests x
# blocks_for(7 prompt + 12 new) = 5 blocks each = up to 20 blocks
# demanded vs 11 allocatable -> the engine MUST preempt to flow
PRESSURE = dict(num_slots=4, max_queue=16, block_size=4, kv_blocks=12,
                decode_chunk=4, preempt=True)
ROOMY = dict(num_slots=4, max_queue=16, block_size=4, decode_chunk=4)


def _cfg(mod):
    return mod(vocab_size=97, hidden=32, layers=2, heads=4, max_pos=64,
               dropout=0.0, attn_impl="xla")


def _pressure_prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 97, (n,)).astype(np.int32) for n in (5, 7, 4, 6)]


@pytest.fixture(scope="module")
def world():
    """The same random weights on both sides."""
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
            "tp": tgd.collect_gpt_params(tscope, tcfg)}


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_queue", 16)
    kw.setdefault("prefill_buckets", (4, 8))
    kw.setdefault("max_len", 32)
    return kw


def make_engine(world, **kw):
    return _opened(ServingEngine(world["tp"], world["tcfg"],
                                 ServingConfig(**_kw(kw))))


def make_jax_engine(world, **kw):
    return _opened(JServingEngine(world["jp"], world["cfg"],
                                  JServingConfig(**_kw(kw))))


def sequential_ref(world, prompt, max_new):
    return tgd.gpt_generate(world["tp"], world["tcfg"],
                            np.asarray(prompt)[None], max_new)[0]


def _jax_scores(world, seq, p_len, i, temperature, seed):
    """JAX's scores for generated token i of `seq`: the logits for a
    greedy draw, logits / temp + the token's Gumbel noise for a seeded
    one (its key is split i times from the request seed)."""
    import jax.numpy as jnp
    logits = np.asarray(gd.gpt_forward_logits(
        world["jp"], world["cfg"], seq[None, :p_len + i]))[0, -1]
    if temperature == 0.0:
        return logits
    key = gd.sample_key(np.uint32(seed))
    for _ in range(i):
        key = gd.sample_split(key)
    scaled = logits / np.float32(temperature)
    return scaled + np.asarray(gd.sample_gumbel(jnp.asarray(key),
                                                scaled.size))


def _same_or_near_tie(world, jax_out, port_out, p_len, temperature=0.0,
                      seed=0, name=""):
    """Port stream == JAX stream, or the first differing token is a
    near-tie in JAX's scores (top-2 margin < TIE)."""
    jax_out, port_out = np.asarray(jax_out), np.asarray(port_out)
    assert jax_out.shape == port_out.shape, name
    diff = np.nonzero(jax_out != port_out)[0]
    if not diff.size:
        return
    i = int(diff[0]) - p_len
    assert i >= 0, f"{name}: prompt differs"
    s = np.sort(_jax_scores(world, jax_out, p_len, i, temperature,
                            seed))[::-1]
    assert s[0] - s[1] < TIE, (
        f"{name}: stream differs from JAX's at generated token {i} "
        f"(margin {s[0] - s[1]} is no near-tie)")


def _drive_until_running_with_tokens(eng, req, n=2):
    """Step until `req` has streamed >= n tokens and is still running."""
    while len(req.tokens) < n:
        eng.step()
    assert not req.finished


def _stream_of(eng, prompt, max_new, **kw):
    out = []
    eng.submit(np.asarray(prompt, np.int32), max_new,
               on_token=lambda r, t: out.append(t), **kw)
    eng.run_until_drained()
    return out


def _assert_clean(eng):
    s = eng.stats()
    assert s["blocks_used"] == 0 and s["swapped_slots"] == 0
    assert s["swap_pool_bytes"] == 0


# -- preemption: streams against the JAX engine ------------------------------

@pytest.mark.parametrize("chunk", [1, 8])
def test_preempt_greedy_identity_and_no_leaks(world, chunk):
    """An over-subscribed arena forces preemptions; every greedy stream
    equals the JAX engine's on the same config and the sequential
    gpt_generate path; the drain leaves no page, no parked record, no
    host bytes; the registry series carry the engine's numbers."""
    prompts = _pressure_prompts()
    cfg = dict(PRESSURE, decode_chunk=chunk)
    eng = make_engine(world, **cfg)
    jeng = make_jax_engine(world, **cfg)
    outs = eng.generate(prompts, max_new_tokens=12)
    jouts = jeng.generate(prompts, max_new_tokens=12)
    s = eng.stats()
    assert s["preemptions"] >= 1, "arena not tight enough to preempt"
    assert s["swap_ins"] == s["preemptions"]
    assert jeng.stats()["preemptions"] >= 1
    for i, (p, o, jo) in enumerate(zip(prompts, outs, jouts)):
        _same_or_near_tie(world, jo, o, p.size, name=f"greedy[{i}]")
        np.testing.assert_array_equal(o, sequential_ref(world, p, 12))
    _assert_clean(eng)
    assert {"swap_out", "swap_in"} <= set(eng.scheduler.compile_events)
    label = s["engine_label"]
    snap = ptt.observability.get_registry().snapshot()
    for fam, want in (("serving_preemptions_total", s["preemptions"]),
                      ("serving_swap_ins_total", s["swap_ins"]),
                      ("serving_swapped_slots", 0)):
        row = next(r for r in snap[fam]["series"]
                   if r["labels"].get("engine") == label)
        assert row["value"] == want, fam
    for fam in ("serving_swap_out_seconds", "serving_swap_in_seconds"):
        hist = next(r for r in snap[fam]["series"]
                    if r["labels"].get("engine") == label)
        assert hist["count"] == s["preemptions"], fam
    from paddle_tpu_torch.observability.debug_server import _serving_varz
    assert _serving_varz(snap)["preemption"][label] == {
        "preemptions": s["preemptions"], "swap_ins": s["swap_ins"],
        "swapped_slots": 0}
    eng.close()


@pytest.mark.parametrize("chunk", [1, 8])
def test_preempt_seeded_identity(world, chunk):
    """Seeded streams through preemption equal the JAX engine's (same
    pressure) and the port's own unpressured run, bit for bit."""
    prompts = _pressure_prompts()
    tight = make_engine(world, **dict(PRESSURE, decode_chunk=chunk))
    roomy = make_engine(world, **dict(ROOMY, decode_chunk=chunk))
    jtight = make_jax_engine(world, **dict(PRESSURE, decode_chunk=chunk))
    kw = dict(max_new_tokens=12, temperature=0.8, seed=3)
    o_t = tight.generate(prompts, **kw)
    o_r = roomy.generate(prompts, **kw)
    o_j = jtight.generate(prompts, **kw)
    assert tight.stats()["preemptions"] >= 1
    assert roomy.stats()["preemptions"] == 0
    for i, (p, a, b, j) in enumerate(zip(prompts, o_t, o_r, o_j)):
        np.testing.assert_array_equal(a, b)
        _same_or_near_tie(world, j, a, p.size, 0.8, 3,
                          name=f"seeded[{i}]")
    _assert_clean(tight)
    tight.close()
    roomy.close()


@pytest.mark.parametrize("policy", ["newest", "oldest", "callable"])
def test_each_preempt_policy_streams_match_jax(world, policy):
    """Every policy preempts and every stream, greedy and seeded, equals
    the JAX engine's under the same policy."""
    pol = (lambda running: min(running)) if policy == "callable" \
        else policy
    prompts = _pressure_prompts()
    kws = [{"temperature": 0.0 if i % 2 == 0 else 0.8, "seed": 20 + i}
           for i in range(len(prompts))]
    eng = make_engine(world, preempt_policy=pol, **PRESSURE)
    jeng = make_jax_engine(world, preempt_policy=pol, **PRESSURE)
    outs, jouts = [], []
    for e, dst in ((eng, outs), (jeng, jouts)):
        reqs = [e.submit(p, 12, **kw) for p, kw in zip(prompts, kws)]
        e.run_until_drained()
        dst.extend(r.output() for r in reqs)
    assert eng.stats()["preemptions"] >= 1
    for i, (p, kw) in enumerate(zip(prompts, kws)):
        _same_or_near_tie(world, jouts[i], outs[i], p.size,
                          kw["temperature"], kw["seed"],
                          name=f"{policy}[{i}]")
    _assert_clean(eng)
    eng.close()


def test_preempt_policy_selection(world):
    """pick_victim: "newest" sacrifices the latest admission, "oldest"
    the earliest, a callable sees the running table and must return one
    of its slots."""
    from types import SimpleNamespace

    eng = make_engine(world, preempt=True)
    sched = eng.scheduler
    assert sched.pick_victim() is None
    sched._running = {3: SimpleNamespace(seq=0),
                      1: SimpleNamespace(seq=2),
                      2: SimpleNamespace(seq=1)}
    try:
        assert sched.pick_victim("newest") == 1
        assert sched.pick_victim("oldest") == 3
        assert sched.pick_victim(lambda running: min(running)) == 1
        with pytest.raises(ValueError, match="not a running slot"):
            sched.pick_victim(lambda running: 9)
        with pytest.raises(ValueError, match="unknown preempt policy"):
            sched.pick_victim("fifo")
    finally:
        sched._running = {}
        eng.close()


def test_swap_cycle_keeps_arena_in_place_and_scratch_untouched(world):
    """A swap-out/swap-in cycle writes the one arena tensor in place
    (same storage) and never touches the scratch block (frozen slots'
    decode writes land there, the swap's do not); the swap record
    carries JAX's layout and dtypes."""
    eng = make_engine(world, num_slots=2, block_size=4, decode_chunk=2)
    arena = eng.kv.kv
    ptr = arena.data_ptr()
    req = eng.submit(np.asarray([5, 6, 7, 8, 9], np.int32), 14,
                     temperature=0.8, seed=4)
    _drive_until_running_with_tokens(eng, req, 3)
    eng._fence()
    arena[:, :, 0] = 7.0                      # mark the scratch block
    slot = next(iter(eng.scheduler._running))
    n = eng.kv.mapped_block_count(slot)
    blocks = eng.kv.page_table[slot, :n].copy()
    before = arena[:, :, torch.as_tensor(blocks, dtype=torch.int64)].clone()
    sw = eng.scheduler.swap_out(slot)
    assert sw.payload.shape == (2, 2, n, 4, 4, 8)
    assert sw.payload.dtype == np.float32
    np.testing.assert_array_equal(sw.payload, before.numpy())
    for f in ("token", "ts", "remaining", "eos"):
        v = getattr(sw, f)
        assert v.dtype == np.int32 and v.shape == (), f
    assert sw.temp.dtype == np.float32 and sw.temp.shape == ()
    assert sw.key_row.dtype == np.uint32 and sw.key_row.shape == (2,)
    assert eng.kv.blocks_used == 0
    slot2 = eng.scheduler.swap_in(sw)
    assert slot2 is not None
    blocks2 = eng.kv.page_table[slot2, :n]
    np.testing.assert_array_equal(
        arena[:, :, torch.as_tensor(blocks2, dtype=torch.int64)].numpy(),
        before.numpy())
    assert bool((arena[:, :, 0] == 7.0).all())
    eng.run_until_drained()
    assert eng.kv.kv is arena and arena.data_ptr() == ptr
    ref = make_engine(world, num_slots=2, block_size=4, decode_chunk=2)
    np.testing.assert_array_equal(
        req.output()[5:],
        _stream_of(ref, [5, 6, 7, 8, 9], 14, temperature=0.8, seed=4))


def test_adopt_blocks_accounting_and_guards(world):
    """adopt_blocks claims private blocks for a resumed sequence (never
    the prefix cache), guards occupied slots and over-asks, and free()
    returns exactly the adopted blocks."""
    kv = SlotKVCache(world["tcfg"], num_slots=2, max_len=16, block_size=4,
                     num_blocks=7)
    s = kv.alloc()
    kv.map_slot(s, np.arange(1, 10, dtype=np.int32), 12)
    assert kv.mapped_block_count(s) == 3
    with pytest.raises(ValueError, match="already has mapped blocks"):
        kv.adopt_blocks(s, 1, 4)
    with pytest.raises(ValueError, match="n_blocks must be >= 1"):
        kv.can_adopt(0)
    assert not kv.can_adopt(kv.blocks_available + 1)
    t = kv.alloc()
    with pytest.raises(ValueError, match="cannot supply"):
        kv.adopt_blocks(t, kv.blocks_available + 1, 4)
    row = kv.adopt_blocks(t, 2, length=6)
    assert kv.mapped_block_count(t) == 2 and kv.length(t) == 6
    assert kv.blocks_used == 5
    assert not set(row[:2]) & set(kv.page_table[s][:3])
    kv.free(t)
    assert kv.blocks_used == 3
    # blocks_needed charges LRU hits, not live-shared ones
    p = np.arange(1, 10, dtype=np.int32)
    assert kv.blocks_needed(p, 12) == 3 - 2      # 2 blocks shared live
    kv.free(s)
    assert kv.blocks_needed(p, 12) == 3          # now an LRU hit


def test_forced_page_shortage_requeues_not_preempts(world):
    """A scheduled page shortage requeues the head-of-line request and
    never evicts a resident, preemption on."""
    plan = FaultPlan(page_shortages={0, 1})
    eng = make_engine(world, preempt=True, fault_plan=plan)
    p = np.asarray([1, 2, 3], np.int32)
    r1, r2 = eng.submit(p, 4), eng.submit(p, 4)
    eng.step()
    assert plan.denied_steps == 1
    assert eng.scheduler.active_count == 0
    assert r1.state == "queued" and r2.state == "queued"
    eng.step()
    assert plan.denied_steps == 2
    eng.run_until_drained()
    assert r1.state == "finished" and r2.state == "finished"
    np.testing.assert_array_equal(r1.output(), sequential_ref(world, p, 4))
    assert eng.stats()["preemptions"] == 0
    eng.close()


def test_drain_with_swapped_sequences_finishes_every_stream(world):
    """Parked sequences count as pending work: the drain swaps them back
    in and every stream finishes with its whole budget."""
    prompts = _pressure_prompts()
    eng = make_engine(world, **PRESSURE)
    streams = {i: [] for i in range(len(prompts))}
    reqs = [eng.submit(p, 12, on_token=(lambda i: lambda r, t:
                                        streams[i].append(t))(i))
            for i, p in enumerate(prompts)]
    seen = 0
    for _ in range(60):
        eng.step()
        seen = max(seen, eng.swapped_count)
        if seen:
            break
    assert seen >= 1
    eng.run_until_drained()
    for i, (req, p) in enumerate(zip(reqs, prompts)):
        assert req.state == "finished" and len(streams[i]) == 12
        np.testing.assert_array_equal(req.output(),
                                      sequential_ref(world, p, 12))
    _assert_clean(eng)
    eng.close()


def test_cancel_of_a_parked_sequence_drops_its_record(world):
    """A cancelled parked request leaves the swap pool at the next step
    and never emits again; the others finish."""
    prompts = _pressure_prompts()
    eng = make_engine(world, **PRESSURE)
    reqs = [eng.submit(p, 12) for p in prompts]
    for _ in range(60):
        eng.step()
        if eng.swapped_count:
            break
    parked = eng._swapped[0].req
    n = len(parked.tokens)
    assert eng.cancel(parked)
    eng.run_until_drained()
    assert parked.state == "cancelled" and len(parked.tokens) == n
    assert all(r.state == "finished" for r in reqs if r is not parked)
    _assert_clean(eng)


def test_request_log_preemption_timeline(world):
    """The request log carries a preempted request's whole phase
    sequence, correlated on request_id."""
    from paddle_tpu_torch.observability import request_log as rl

    with rl.request_logging() as log:
        eng = make_engine(world, **PRESSURE)
        reqs = [eng.submit(p, max_new_tokens=12)
                for p in _pressure_prompts()]
        eng.run_until_drained()
        assert eng.stats()["preemptions"] >= 1
        eng.close()
    events = log.recent()
    ids = {e["request_id"] for e in events if e["kind"] == "preempted"}
    assert ids
    kinds = [e["kind"] for e in events
             if e["request_id"] == sorted(ids)[0]]
    for needed in ("submitted", "queued", "admitted", "prefill",
                   "preempted", "swapped_in", "decode", "finished"):
        assert needed in kinds, (needed, kinds)
    assert kinds.index("admitted") < kinds.index("preempted") \
        < kinds.index("swapped_in") < len(kinds) - 1
    assert kinds[-1] == "finished"
    assert all(r.state == "finished" and len(r.tokens) == 12
               for r in reqs)


# -- migration ------------------------------------------------------------------

@pytest.mark.parametrize("temp,seed", [(0.0, 0), (0.8, 3)])
def test_migrate_stream_identity(world, temp, seed):
    """A stream migrated mid-generation between two port engines equals
    the JAX engine's never-migrated stream; both engines drain clean."""
    p = np.asarray([3, 1, 4, 1, 5], np.int32)
    src = make_engine(world, decode_chunk=4, max_len=48)
    dst = make_engine(world, decode_chunk=4, max_len=48)
    stream = []
    req = src.submit(p, 40, temperature=temp, seed=seed,
                     on_token=lambda r, t: stream.append(t))
    _drive_until_running_with_tokens(src, req)
    ticket = src.migrate_out(req)
    assert ticket.verify() and ticket.emitted == len(stream)
    assert req.state == "migrated"
    req2 = dst.migrate_in(ticket, on_token=lambda r, t: stream.append(t))
    src.run_until_drained()
    dst.run_until_drained()
    assert req2.state == "finished"
    jref = _stream_of(make_jax_engine(world, decode_chunk=4, max_len=48),
                      p, 40, temperature=temp, seed=seed)
    _same_or_near_tie(world, np.concatenate([p, jref]),
                      np.concatenate([p, stream]), p.size, temp, seed,
                      name=f"migrated(temp={temp})")
    for eng in (src, dst):
        _assert_clean(eng)
        eng.close()


def test_migrate_with_prefix_cache_hit_stream_identical(world):
    """A sequence whose prompt mapped shared prefix-cache blocks
    migrates to a cold engine (the shared contents land in private
    blocks) and stays identical to a never-migrated warm run."""
    rng = np.random.RandomState(11)
    sys_prompt = rng.randint(0, 97, (8,)).astype(np.int32)
    pa = np.concatenate([sys_prompt, rng.randint(0, 97, (3,))]).astype(
        np.int32)
    pb = np.concatenate([sys_prompt, rng.randint(0, 97, (3,))]).astype(
        np.int32)
    kw = dict(num_slots=2, block_size=4, decode_chunk=4, max_len=48,
              prefill_buckets=(4, 16))

    def warm():
        eng = make_engine(world, **kw)
        eng.generate([pa], max_new_tokens=4)
        return eng

    src, dst = warm(), make_engine(world, **kw)
    stream = []
    req = src.submit(pb, 30, temperature=0.7, seed=9,
                     on_token=lambda r, t: stream.append(t))
    _drive_until_running_with_tokens(src, req)
    assert src.kv.prefix_hits > 0
    req2 = dst.migrate_in(src.migrate_out(req),
                          on_token=lambda r, t: stream.append(t))
    src.run_until_drained()
    dst.run_until_drained()
    assert req2.state == "finished"
    assert stream == _stream_of(warm(), pb, 30, temperature=0.7, seed=9)
    jwarm = make_jax_engine(world, **kw)
    jwarm.generate([pa], max_new_tokens=4)
    jref = _stream_of(jwarm, pb, 30, temperature=0.7, seed=9)
    _same_or_near_tie(world, np.concatenate([pb, jref]),
                      np.concatenate([pb, stream]), pb.size, 0.7, 9,
                      name="prefix-hit migration")


def test_migrate_parked_sequence_from_swap_pool(world):
    """A parked sequence migrates without a fence or device call and
    resumes bit-identically on the target; no page leaks either side."""
    prompts = _pressure_prompts()
    tight = make_engine(world, **PRESSURE)
    roomy = make_engine(world, num_slots=4, block_size=4, decode_chunk=4)
    streams = {i: [] for i in range(len(prompts))}

    def tap(i):
        return lambda req, tok: streams[i].append(tok)

    reqs = [tight.submit(p, 12, temperature=0.8, seed=3, on_token=tap(i))
            for i, p in enumerate(prompts)]
    for _ in range(60):
        tight.step()
        if tight.swapped_count:
            break
    assert tight.swapped_count >= 1
    parked = tight._swapped[0].req
    before = tight.swapped_count
    ticket = tight.migrate_out(parked)
    assert tight.swapped_count == before - 1
    roomy.migrate_in(ticket, on_token=tap(reqs.index(parked)))
    tight.run_until_drained()
    roomy.run_until_drained()
    ref = make_engine(world, **ROOMY)
    ref_streams = {i: [] for i in range(len(prompts))}
    for i, p in enumerate(prompts):
        ref.submit(p, 12, temperature=0.8, seed=3,
                   on_token=(lambda i: lambda r, t:
                             ref_streams[i].append(t))(i))
    ref.run_until_drained()
    assert streams == ref_streams
    for eng in (tight, roomy):
        _assert_clean(eng)
        eng.close()


def test_migrate_out_refuses_during_drain_not_deadlock(world):
    """migrate_out/migrate_in on a draining engine refuse with
    MigrationError; the drain still finishes the stream, and a refused
    ticket adopts elsewhere."""
    p = np.asarray([1, 2, 3], np.int32)
    src = make_engine(world, decode_chunk=4, max_len=48)
    peer = make_engine(world, decode_chunk=4, max_len=48)
    req = src.submit(p, 30)
    _drive_until_running_with_tokens(src, req)
    src.begin_drain()
    assert src.draining
    with pytest.raises(MigrationError, match="draining"):
        src.migrate_out(req)
    src.run_until_drained()
    assert req.state == "finished" and len(req.tokens) == 30
    np.testing.assert_array_equal(req.output(),
                                  sequential_ref(world, p, 30))
    req2 = peer.submit(p, 30)
    _drive_until_running_with_tokens(peer, req2)
    ticket = peer.migrate_out(req2)
    with pytest.raises(MigrationError, match="draining"):
        src.migrate_in(ticket)
    other = make_engine(world, decode_chunk=4, max_len=48)
    req3 = other.migrate_in(ticket)
    peer.run_until_drained()
    other.run_until_drained()
    np.testing.assert_array_equal(req3.output(),
                                  sequential_ref(world, p, 30))


def test_migration_ticket_integrity_and_compatibility(world):
    """A corrupted payload fails the checksum and a geometry mismatch is
    rejected whole (TicketError, nothing mutated); the intact ticket
    still adopts."""
    p = np.asarray([5, 7, 11], np.int32)
    src = make_engine(world, decode_chunk=4, max_len=48)
    req = src.submit(p, 30)
    _drive_until_running_with_tokens(src, req)
    ticket = src.migrate_out(req)
    assert ticket.version == ptt.serving.TICKET_VERSION == 3
    assert ticket.swap_bytes == ticket.payload.nbytes
    tampered = ticket.payload.copy()
    tampered[0, 0, 0, 0, 0, 0] += 1.0
    good, ticket.payload = ticket.payload, tampered
    assert not ticket.verify()
    victim = make_engine(world, decode_chunk=4, max_len=48)
    with pytest.raises(TicketError, match="checksum"):
        victim.migrate_in(ticket)
    assert victim.stats()["swapped_slots"] == 0
    ticket.payload = good
    assert ticket.verify()
    with pytest.raises(TicketError, match="block_size"):
        make_engine(world, block_size=8, max_len=48).migrate_in(ticket)
    assert not ticket.compatible(make_engine(world, block_size=8,
                                             max_len=48))
    dst = make_engine(world, decode_chunk=4, max_len=48)
    req2 = dst.migrate_in(ticket)
    dst.run_until_drained()
    np.testing.assert_array_equal(req2.output(),
                                  sequential_ref(world, p, 30))


def test_migration_request_log_chains_hops(world):
    """migrate_out/migrate_in land in the request log with replica
    labels and bytes; the adopting id chains to the source id."""
    from paddle_tpu_torch.observability import request_log as rl

    with rl.request_logging() as log:
        src = make_engine(world, decode_chunk=4, max_len=48)
        dst = make_engine(world, decode_chunk=4, max_len=48)
        req = src.submit(np.asarray([3, 1, 4], np.int32), 20)
        _drive_until_running_with_tokens(src, req)
        req2 = dst.migrate_in(src.migrate_out(req))
        dst.run_until_drained()
    events = log.recent()
    out = next(e for e in events if e["kind"] == "migrate_out")
    inn = next(e for e in events if e["kind"] == "migrate_in")
    assert out["request_id"] == req.request_id and out["bytes"] > 0
    assert inn["request_id"] == req2.request_id
    assert inn["rerouted_from"] == req.request_id
    assert out["replica"] == src.metrics.engine_label


# -- tickets across the two packages --------------------------------------------

def _rewrap(ticket, cls):
    """The ticket as the receiving package reconstructs it from the
    sender's fields and checksum (the wire story)."""
    fields = {f: getattr(ticket, f) for f in (
        "prompt", "max_new", "temperature", "seed", "eos_id", "tokens",
        "request_id", "pos", "produced", "seq", "length", "n_blocks",
        "block_size", "payload", "token", "ts", "remaining", "temp", "eos",
        "key_row", "spec", "tenant", "rerouted_from", "slo_stamps",
        "version", "checksum", "created_unix", "mesh_shape", "scales",
        "adapter_id", "adapter_digest")}
    return cls(**fields)


_DT = ("token", "ts", "remaining", "temp", "eos", "key_row", "payload")


@pytest.mark.parametrize("temp,seed", [(0.0, 0), (0.8, 5)])
def test_jax_ticket_resumes_on_the_port(world, temp, seed):
    """A ticket the JAX engine extracts verifies under the port's class
    with JAX's checksum and finishes the stream on the port's engine as
    JAX's never-migrated run does."""
    p = np.asarray([3, 1, 4, 1, 5], np.int32)
    src = make_jax_engine(world, decode_chunk=4, max_len=48)
    stream = []
    req = src.submit(p, 30, temperature=temp, seed=seed,
                     on_token=lambda r, t: stream.append(t))
    _drive_until_running_with_tokens(src, req, 3)
    jt = src.migrate_out(req)
    ticket = _rewrap(jt, MigrationTicket)
    assert ticket.verify() and ticket.checksum == jt.checksum
    dst = make_engine(world, decode_chunk=4, max_len=48)
    dst.migrate_in(ticket, on_token=lambda r, t: stream.append(t))
    dst.run_until_drained()
    jref = _stream_of(make_jax_engine(world, decode_chunk=4, max_len=48),
                      p, 30, temperature=temp, seed=seed)
    _same_or_near_tie(world, np.concatenate([p, jref]),
                      np.concatenate([p, stream]), p.size, temp, seed,
                      name="JAX ticket on the port")
    _assert_clean(dst)


@pytest.mark.parametrize("temp,seed", [(0.0, 0), (0.8, 5)])
def test_port_ticket_resumes_on_jax(world, temp, seed):
    """The reverse: a port ticket's fields carry JAX's dtypes, its
    checksum verifies under JAX's class, and the JAX engine finishes the
    stream as its own never-migrated run does."""
    p = np.asarray([3, 1, 4, 1, 5], np.int32)
    src = make_engine(world, decode_chunk=4, max_len=48)
    stream = []
    req = src.submit(p, 30, temperature=temp, seed=seed,
                     on_token=lambda r, t: stream.append(t))
    _drive_until_running_with_tokens(src, req, 3)
    tt = src.migrate_out(req)
    jt = _rewrap(tt, JMigrationTicket)
    assert jt.verify() and jt.checksum == tt.checksum

    # the same sequence extracted by JAX at the same point has the same
    # field dtypes and shapes
    jsrc = make_jax_engine(world, decode_chunk=4, max_len=48)
    jreq = jsrc.submit(p, 30, temperature=temp, seed=seed)
    _drive_until_running_with_tokens(jsrc, jreq, 3)
    jown = jsrc.migrate_out(jreq)
    for f in _DT:
        a, b = np.asarray(getattr(tt, f)), np.asarray(getattr(jown, f))
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f
    if len(tt.tokens) == len(jown.tokens):
        np.testing.assert_array_equal(tt.key_row, jown.key_row)

    dst = make_jax_engine(world, decode_chunk=4, max_len=48)
    dst.migrate_in(jt, on_token=lambda r, t: stream.append(t))
    dst.run_until_drained()
    jref = _stream_of(make_jax_engine(world, decode_chunk=4, max_len=48),
                      p, 30, temperature=temp, seed=seed)
    _same_or_near_tie(world, np.concatenate([p, jref]),
                      np.concatenate([p, stream]), p.size, temp, seed,
                      name="port ticket on JAX")


def test_jax_ticket_with_drafter_rows_is_refused(world):
    """A ticket from a speculating JAX engine carries drafter rows a
    speculate_k=0 engine has no place for: TicketError, nothing adopted,
    as the JAX engine refuses it too (tests/test_torch_serving_spec.py
    adopts such tickets into speculating engines)."""
    p = np.asarray([3, 1, 4, 1, 5], np.int32)
    src = make_jax_engine(world, decode_chunk=4, max_len=48, speculate_k=2)
    req = src.submit(p, 30)
    _drive_until_running_with_tokens(src, req, 3)
    ticket = _rewrap(src.migrate_out(req), MigrationTicket)
    assert ticket.verify() and ticket.spec is not None
    dst = make_engine(world, decode_chunk=4, max_len=48)
    with pytest.raises(TicketError, match="speculation"):
        dst.migrate_in(ticket)
    assert dst.swapped_count == 0


def test_bf16_arena_swaps_and_migrates(world):
    """A bf16 checkpoint's arena swaps through the host as JAX's bf16
    (ml_dtypes) payload: seeded streams through preemption equal the
    unpressured run, and a ticket carries a bfloat16 payload that
    verifies and resumes."""
    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        if isinstance(x, list):
            return [cast(v) for v in x]
        return x.to(torch.bfloat16)

    params = cast(world["tp"])
    prompts = _pressure_prompts()

    def engine(**kw):
        return _opened(ServingEngine(params, world["tcfg"],
                                     ServingConfig(**_kw(kw))))

    tight, roomy = engine(**PRESSURE), engine(**ROOMY)
    kw = dict(max_new_tokens=12, temperature=0.8, seed=3)
    for a, b in zip(tight.generate(prompts, **kw),
                    roomy.generate(prompts, **kw)):
        np.testing.assert_array_equal(a, b)
    assert tight.kv.kv.dtype == torch.bfloat16
    assert tight.stats()["preemptions"] >= 1
    req = tight.submit(prompts[0], 20, temperature=0.8, seed=1)
    _drive_until_running_with_tokens(tight, req)
    ticket = tight.migrate_out(req)
    assert str(ticket.payload.dtype) == "bfloat16" and ticket.verify()
    req2 = roomy.migrate_in(ticket)
    roomy.run_until_drained()
    np.testing.assert_array_equal(
        req2.output()[prompts[0].size:],
        _stream_of(engine(**ROOMY), prompts[0], 20, temperature=0.8,
                   seed=1))
