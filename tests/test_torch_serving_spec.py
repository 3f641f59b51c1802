"""Speculative decoding in the PyTorch port's serving engine against the
JAX package's, on the CPU, on the tiny GPT of tests/test_torch_serving.py
(vocab 97, hidden 32, 2 layers) with its engine defaults (2 slots,
buckets 4 and 8, max_len 32). The non-slow `test_spec_*` contracts of
tests/test_serving.py on the port, every stream held to the JAX engine's
on the same weights:

  * greedy and seeded streams at decode_chunk 1, 4 and 8 and k 1 and 3
    equal the JAX engine's token for token, and so do the
    `serving_spec_{proposed,accepted}_total` counters;
  * EOS mid-run, a prefix-cache hit, slot reuse and a cancel mid-chunk;
    the acceptance telemetry of a repetitive prompt and its registry
    series; speculation never costs dispatches; the metrics' bucket
    scaling;
  * seeded preemption with speculation on equals the unpressured run;
  * tickets with drafter rows cross both ways (JAX -> port, port -> JAX)
    and a drafter-table width mismatch is refused;
  * `server.serve` with two speculating replicas streams the JAX
    engine's tokens; the bench's `--speculate 0 2` rows on `tiny`.
"""

import http.client
import json
import threading

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import gpt_decode as gd
from paddle_tpu.models.gpt import GPTConfig, gpt_lm_program
from paddle_tpu.serving import MigrationTicket as JMigrationTicket
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch.models import gpt_decode as tgd
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.serving import (MigrationTicket, ServingConfig,
                                      ServingEngine, TicketError)
from test_torch_serving import _close_engines, _opened  # noqa: F401
from torch_port_common import one_torch_thread  # noqa: F401


TOP_K = 5
PRESSURE = dict(num_slots=4, max_queue=16, block_size=4, kv_blocks=12,
                decode_chunk=4, preempt=True)


def _cfg(mod):
    return mod(vocab_size=97, hidden=32, layers=2, heads=4, max_pos=64,
               dropout=0.0, attn_impl="xla")


def _mix():
    """Six requests: three tile a motif (the drafter's regime), three
    are random; even ones greedy, odd ones seeded."""
    rng = np.random.RandomState(50)
    prompts = []
    for i in range(6):
        if i % 2 == 0:
            prompts.append(np.tile(rng.randint(0, 97, 3), 3)[:6 + i // 2]
                           .astype(np.int32))
        else:
            prompts.append(rng.randint(0, 97, (3 + i,)).astype(np.int32))
    kws = [{"temperature": 0.0 if i % 2 == 0 else 0.8, "seed": 60 + i}
           for i in range(6)]
    return prompts, kws


MIX = _mix()


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_queue", 16)
    kw.setdefault("prefill_buckets", (4, 8))
    kw.setdefault("max_len", 32)
    return kw


def _drain(eng, prompts, max_new, kws):
    reqs = [eng.submit(p, max_new, **kw) for p, kw in zip(prompts, kws)]
    eng.run_until_drained()
    return [r.output() for r in reqs]


@pytest.fixture(scope="module")
def world():
    """The same random weights on both sides, and the JAX engine's mix
    streams and speculation counters at k 0, 1 and 3."""
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
    w = {"cfg": cfg, "jp": jp, "tcfg": tcfg,
         "tp": tgd.collect_gpt_params(tscope, tcfg), "mix": {}}
    for k in (0, 1, 3):
        jeng = make_jax_engine(w, num_slots=4, top_k=TOP_K, decode_chunk=4,
                               speculate_k=k)
        outs = _drain(jeng, MIX[0], 10, MIX[1])
        w["mix"][k] = (outs, jeng.scheduler.spec_proposed,
                       jeng.scheduler.spec_accepted)
        jeng.close()
    return w


def make_engine(world, **kw):
    return _opened(ServingEngine(world["tp"], world["tcfg"],
                                 ServingConfig(**_kw(kw))))


def make_jax_engine(world, **kw):
    return _opened(JServingEngine(world["jp"], world["cfg"],
                                  JServingConfig(**_kw(kw))))


def sequential_ref(world, prompt, max_new):
    return tgd.gpt_generate(world["tp"], world["tcfg"],
                            np.asarray(prompt)[None], max_new)[0]


def _stream_of(eng, prompt, max_new, **kw):
    out = []
    eng.submit(np.asarray(prompt, np.int32), max_new,
               on_token=lambda r, t: out.append(t), **kw)
    eng.run_until_drained()
    return out


def _drive_until_running_with_tokens(eng, req, n=2):
    while len(req.tokens) < n:
        eng.step()
    assert not req.finished


def _series(snap, fam, label):
    return next(r for r in snap[fam]["series"]
                if r["labels"].get("engine") == label)


# -- streams and counters against the JAX engine ----------------------------

@pytest.mark.parametrize("chunk", [1, 4, 8])
@pytest.mark.parametrize("k", [1, 3])
def test_spec_streams_and_counters_match_jax(world, k, chunk):
    """The mix on 4 slots: every stream equals the JAX engine's (and its
    own speculate_k=0 stream), the spec counters equal JAX's, and the
    loop is still one family."""
    outs_j, prop_j, acc_j = world["mix"][k]
    eng = make_engine(world, num_slots=4, top_k=TOP_K, decode_chunk=chunk,
                      speculate_k=k)
    outs = _drain(eng, MIX[0], 10, MIX[1])
    for i, (a, b, c) in enumerate(zip(outs_j, outs, world["mix"][0][0])):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
        np.testing.assert_array_equal(b, c, err_msg=f"request {i}, k=0")
    sched = eng.scheduler
    assert (sched.spec_proposed, sched.spec_accepted) == (prop_j, acc_j)
    assert sched.spec_proposed == k * sched.spec_passes
    s = eng.stats()
    assert (s["spec_proposed"], s["spec_accepted"]) == (prop_j, acc_j)
    assert acc_j > 0
    events = sched.compile_events
    assert events.count("decode_chunk") == 1, events
    assert sched.compile_count <= len(eng.buckets) + 2
    eng.close()


def test_spec_mid_chunk_eos_retires_early(world):
    """EOS emitted inside a verify run freezes the slot at exactly that
    token: nothing after it is emitted and the slot frees."""
    rng = np.random.RandomState(7)
    k = None
    for _ in range(20):
        p = rng.randint(0, 97, (3,)).astype(np.int32)
        gen = list(sequential_ref(world, p, 12)[3:])
        k = next((i for i in range(1, len(gen))
                  if gen[i] not in gen[:i]), None)
        if k is not None and k % 8 != 7:
            break
    assert k is not None, "no usable greedy stream found"
    eos = int(gen[k])
    eng = make_engine(world, decode_chunk=8, speculate_k=3)
    req = eng.submit(p, max_new_tokens=12, eos_id=eos)
    eng.run_until_drained()
    assert req.finished
    assert req.tokens[-1] == eos and len(req.tokens) == k + 1
    assert eng.stats()["free_slots"] == eng.kv.num_slots
    eng.close()


def test_spec_prefix_cache_hit_stream_identical(world):
    """A prefix-cache hit seeds the drafter from the shrunken suffix
    only; the warm stream still equals the cold one and the sequential
    path."""
    p = np.random.RandomState(42).randint(0, 97, (10,)).astype(np.int32)
    eng = make_engine(world, prefill_buckets=(4, 16), block_size=4,
                      speculate_k=2)
    (cold,) = eng.generate([p], max_new_tokens=6)
    (warm,) = eng.generate([p], max_new_tokens=6)
    assert eng.kv.prefix_hits == 2
    np.testing.assert_array_equal(warm, cold)
    np.testing.assert_array_equal(warm, sequential_ref(world, p, 6))
    eng.close()


def test_spec_retire_admit_slot_reuse(world):
    """Budgets ending mid-chunk through one slot: each admission resets
    the drafter row and every stream stays sequential-identical."""
    rng = np.random.RandomState(43)
    prompts = [rng.randint(0, 97, (2 + i,)).astype(np.int32)
               for i in range(3)]
    budgets = [5, 3, 6]
    eng = make_engine(world, num_slots=1, decode_chunk=4, speculate_k=2)
    reqs = [eng.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, budgets)]
    eng.run_until_drained()
    for r, p, m in zip(reqs, prompts, budgets):
        assert r.finished and len(r.tokens) == m
        np.testing.assert_array_equal(r.output(),
                                      sequential_ref(world, p, m))
    eng.close()


def test_spec_cancel_mid_chunk_discards_unverified(world):
    """A cancel with speculation on drops the in-flight (token, count)
    columns and the drafter state; a follow-up through the same slot
    matches the sequential path."""
    rng = np.random.RandomState(44)
    eng = make_engine(world, num_slots=1, decode_chunk=4, speculate_k=3)
    a = eng.submit(rng.randint(0, 97, (3,)).astype(np.int32),
                   max_new_tokens=20)
    eng.step()
    eng.step()
    n_a = len(a.tokens)
    assert n_a < 20
    assert eng.cancel(a) and a.state == "cancelled"
    eng.run_until_drained()
    assert len(a.tokens) == n_a
    assert eng.kv.free_count == 1
    assert "release_slot" in eng.scheduler.compile_events
    p2 = rng.randint(0, 97, (5,)).astype(np.int32)
    (out,) = eng.generate([p2], max_new_tokens=6)
    np.testing.assert_array_equal(out, sequential_ref(world, p2, 6))
    eng.close()


def test_spec_acceptance_telemetry_repetitive_prompt(world):
    """A tiled motif: > 2 tokens a verify pass, the counters equal the
    JAX engine's on the same request, and the registry's counters,
    acceptance histogram and /varz rollup carry the engine's numbers."""
    from paddle_tpu_torch.observability import get_registry
    from paddle_tpu_torch.observability.debug_server import _serving_varz
    motif = np.random.RandomState(45).randint(0, 97, (4,))
    p = np.tile(motif, 2).astype(np.int32)
    kw = dict(num_slots=1, prefill_buckets=(8,), max_len=48, decode_chunk=8,
              speculate_k=4)
    jeng = make_jax_engine(world, **kw)
    (jout,) = jeng.generate([p], max_new_tokens=32)
    eng = make_engine(world, **kw)
    (out,) = eng.generate([p], max_new_tokens=32)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, sequential_ref(world, p, 32))
    sched, jsched = eng.scheduler, jeng.scheduler
    assert (sched.spec_passes, sched.spec_proposed, sched.spec_accepted) \
        == (jsched.spec_passes, jsched.spec_proposed, jsched.spec_accepted)
    assert sched.spec_proposed == 4 * sched.spec_passes
    assert (sched.spec_passes + sched.spec_accepted) / sched.spec_passes \
        > 2.0
    s = eng.stats()
    assert s["spec_proposed"] == sched.spec_proposed
    assert s["spec_accepted"] == sched.spec_accepted
    assert s["mean_spec_accepted_run"] > 1.0
    snap = get_registry().snapshot()
    label = s["engine_label"]
    assert _series(snap, "serving_spec_proposed_total", label)["value"] \
        == sched.spec_proposed
    assert _series(snap, "serving_spec_accepted_total", label)["value"] \
        == sched.spec_accepted
    assert _series(snap, "serving_spec_accepted_run", label)["count"] \
        == sched.spec_passes
    varz = _serving_varz(snap)["spec_accept_ratio"][label]
    assert varz["spec_proposed"] == sched.spec_proposed
    assert varz["spec_accept_ratio"] == round(
        sched.spec_accepted / sched.spec_proposed, 4)
    eng.close()
    jeng.close()


def test_spec_dispatch_floor_preserved(world):
    """Speculation only over-delivers: never more dispatches than the
    non-spec path needs, and fewer on a drafter-friendly stream."""
    motif = np.random.RandomState(46).randint(0, 97, (4,))
    p = np.tile(motif, 2).astype(np.int32)
    counts = {}
    for k in (0, 4):
        eng = make_engine(world, num_slots=1, prefill_buckets=(8,),
                          max_len=48, decode_chunk=8, speculate_k=k)
        eng.generate([p], max_new_tokens=32)
        n = eng.stats()["dispatches"]
        assert 1 <= n <= -(-31 // 8) + 1
        counts[k] = n
        eng.close()
    assert counts[4] < counts[0], counts


def test_spec_metrics_bucket_scaling():
    """The tokens-a-dispatch series widens to chunk * (1 + k) a slot
    and the acceptance histogram spans exactly 0..k."""
    from paddle_tpu_torch.serving.metrics import (_TPD_BASE, EngineMetrics,
                                                  _count_buckets)
    assert _count_buckets(512) == _TPD_BASE
    m = EngineMetrics(max_tokens_per_dispatch=16 * 8 * 5, speculate_k=4)
    tpd = m._hists["tokens_per_dispatch"]
    assert tpd._bounds[-1] == 1024 and tpd._bounds[0] == 1
    assert m._hists["spec_accepted_run"]._bounds == (0, 1, 2, 3, 4)
    m.observe_dispatch_tokens(640)
    assert dict(tpd.cumulative_buckets())["1024"] == 1
    m.unregister()
    m2 = EngineMetrics()
    assert m2._hists["tokens_per_dispatch"]._bounds == _TPD_BASE
    m2.unregister()


def test_spec_engine_sizes_its_metrics_and_validates(world):
    """The engine sizes its histograms for 1 + k tokens a pass; the
    scheduler refuses a negative k or an empty table."""
    eng = make_engine(world, num_slots=3, decode_chunk=4, speculate_k=2)
    assert eng.metrics.max_tokens_per_dispatch == 3 * 4 * 3
    assert eng.metrics._hists["spec_accepted_run"]._bounds == (0, 1, 2)
    eng.close()
    with pytest.raises(ValueError, match="speculate_k"):
        make_engine(world, speculate_k=-1)
    with pytest.raises(ValueError, match="speculate_ngram"):
        make_engine(world, speculate_k=2, speculate_ngram=0)


# -- preemption and tickets ---------------------------------------------------

def test_preempt_seeded_stream_identity_with_speculation(world):
    """A preempted, swapped and resumed speculating run emits the
    unpressured run's seeded streams bit for bit (the drafter rows travel
    with the record)."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 97, (n,)).astype(np.int32)
               for n in (5, 7, 4, 6)]
    tight = make_engine(world, speculate_k=2, **PRESSURE)
    roomy = make_engine(world, num_slots=4, max_queue=16, block_size=4,
                        decode_chunk=4, speculate_k=2)
    kw = dict(max_new_tokens=12, temperature=0.8, seed=3)
    for a, b in zip(tight.generate(prompts, **kw),
                    roomy.generate(prompts, **kw)):
        np.testing.assert_array_equal(a, b)
    s = tight.stats()
    assert s["preemptions"] >= 1 and s["blocks_used"] == 0
    assert roomy.stats()["preemptions"] == 0


def _rewrap(ticket, cls):
    fields = {f: getattr(ticket, f) for f in (
        "prompt", "max_new", "temperature", "seed", "eos_id", "tokens",
        "request_id", "pos", "produced", "seq", "length", "n_blocks",
        "block_size", "payload", "token", "ts", "remaining", "temp", "eos",
        "key_row", "spec", "tenant", "rerouted_from", "slo_stamps",
        "version", "checksum", "created_unix", "mesh_shape", "scales",
        "adapter_id", "adapter_digest")}
    return cls(**fields)


SPEC_KW = dict(decode_chunk=4, max_len=48, speculate_k=2,
               speculate_ngram=64)
TICKET_PROMPT = np.asarray([3, 1, 4, 1, 3, 1, 4, 1], np.int32)


@pytest.mark.parametrize("temp,seed", [(0.0, 0), (0.8, 5)])
def test_jax_drafter_ticket_resumes_on_the_port(world, temp, seed):
    """A speculating JAX engine's ticket (drafter rows included) verifies
    under the port's class and finishes on the port's speculating engine
    as JAX's never-migrated run does; a width mismatch is refused."""
    p = TICKET_PROMPT
    src = make_jax_engine(world, **SPEC_KW)
    stream = []
    req = src.submit(p, 30, temperature=temp, seed=seed,
                     on_token=lambda r, t: stream.append(t))
    _drive_until_running_with_tokens(src, req, 3)
    ticket = _rewrap(src.migrate_out(req), MigrationTicket)
    assert ticket.verify() and ticket.spec is not None
    assert np.asarray(ticket.spec[1]).shape == (65,)
    narrow = make_engine(world, **dict(SPEC_KW, speculate_ngram=32))
    with pytest.raises(TicketError, match="width"):
        narrow.migrate_in(ticket)
    assert narrow.swapped_count == 0
    dst = make_engine(world, **SPEC_KW)
    dst.migrate_in(ticket, on_token=lambda r, t: stream.append(t))
    dst.run_until_drained()
    # the source engine, drained, serves the never-migrated reference
    src.run_until_drained()
    assert stream == _stream_of(src, p, 30, temperature=temp, seed=seed)
    assert dst.stats()["blocks_used"] == 0


@pytest.mark.parametrize("temp,seed", [(0.0, 0), (0.8, 5)])
def test_port_drafter_ticket_resumes_on_jax(world, temp, seed):
    """The reverse: the port's drafter rows carry JAX's dtypes and
    shapes, equal JAX's own at the same point, its checksum verifies
    under JAX's class, and the JAX engine finishes the stream as its own
    never-migrated run does."""
    p = TICKET_PROMPT
    src = make_engine(world, **SPEC_KW)
    stream = []
    req = src.submit(p, 30, temperature=temp, seed=seed,
                     on_token=lambda r, t: stream.append(t))
    _drive_until_running_with_tokens(src, req, 3)
    tt = src.migrate_out(req)
    jt = _rewrap(tt, JMigrationTicket)
    assert jt.verify() and jt.checksum == tt.checksum
    # one JAX engine extracts the same sequence at the same point, then
    # adopts the port's ticket, then serves the never-migrated reference
    jeng = make_jax_engine(world, **SPEC_KW)
    jreq = jeng.submit(p, 30, temperature=temp, seed=seed)
    _drive_until_running_with_tokens(jeng, jreq, 3)
    jown = jeng.migrate_out(jreq)
    for a, b in zip(tt.spec, jown.spec):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        if len(tt.tokens) == len(jown.tokens):
            np.testing.assert_array_equal(a, b)
    jeng.run_until_drained()
    jeng.migrate_in(jt, on_token=lambda r, t: stream.append(t))
    jeng.run_until_drained()
    assert stream == _stream_of(jeng, p, 30, temperature=temp, seed=seed)


# -- the server and the bench -------------------------------------------------

def _sse_tokens(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/generate", json.dumps(payload),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200, r.read()
        tokens, done, event = [], None, "message"
        for line in iter(r.readline, b""):
            line = line.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[7:]
            elif line.startswith("data: "):
                obj = json.loads(line[6:])
                if event == "done":
                    done = obj
                else:
                    tokens.append(obj["token"])
            elif not line:
                event = "message"
        return tokens, done
    finally:
        conn.close()


def test_serve_two_speculating_replicas_streams_match_jax(world):
    """`server.serve()` with two replicas whose ServingConfig speculates:
    concurrent HTTP streams, greedy and seeded, each the JAX engine's,
    and both replicas' drafters at work."""
    from paddle_tpu_torch.server import ServerConfig
    srv = ptt.server.serve(world["tp"], world["tcfg"], ServerConfig(
        replicas=2, serving=ServingConfig(**_kw(dict(
            num_slots=2, decode_chunk=4, speculate_k=3, top_k=TOP_K)))))
    prompts, kws = MIX
    results = {}

    def run(i):
        results[i] = _sse_tokens(srv.port, dict(
            prompt=prompts[i].tolist(), max_new_tokens=10, **kws[i]))

    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, p in enumerate(prompts):
            tokens, done = results[i]
            assert done["finish_reason"] == "length"
            assert tokens == list(world["mix"][3][0][i][p.size:]), i
        engines = [r.engine for r in srv.router.replicas]
        assert all(e.config.speculate_k == 3 for e in engines)
        assert sum(e.scheduler.spec_accepted for e in engines) > 0
    finally:
        srv.shutdown()


def test_bench_serving_speculate_rows():
    """`bench_serving tiny --speculate 0 2`: one row a K, the K=0 row
    without spec columns, the K=2 row with > 1 token a verify pass and
    no more dispatches than K=0."""
    from paddle_tpu_torch.tools import bench_serving
    rows = bench_serving.run_speculate("tiny", speculate_ks=(0, 2),
                                       requests=4, concurrency=2,
                                       device="cpu")
    assert [r["metric"] for r in rows] == ["tiny_serving_spec_c2_s0",
                                           "tiny_serving_spec_c2_s2"]
    for row, k in zip(rows, (0, 2)):
        e = row["extra"]
        assert row["value"] > 0 and e["speculate_k"] == k
        assert e["completed"] == 4 and e["dispatches"] > 0
        assert e["dispatches_per_token"] <= 1.0 / 8 + 1e-9
    base, spec = rows[0]["extra"], rows[1]["extra"]
    assert base["spec_proposed"] == 0 and base["accepted_per_pass"] is None
    assert 0 < spec["spec_accepted"] <= spec["spec_proposed"]
    assert spec["accepted_per_pass"] > 1.0
    assert spec["dispatches"] <= base["dispatches"]
    with pytest.raises(SystemExit):
        bench_serving.main(["tiny", "--device", "cpu", "--speculate", "-1"])
