"""The PyTorch port's continuous-batching engine (`paddle_tpu_torch.
serving`) against the JAX package's, on the CPU, on the tiny GPT and the
`make_engine` defaults of tests/test_serving.py (2 slots, buckets 4 and
8, max_len 32). One JAX engine per module produces the reference
streams; the port's engines, whatever their slots, chunk size, overlap
and block size, must emit them token for token:

  * greedy and seeded streams for 3 prompts on 2 slots and for 10
    concurrent requests; seeded streams at decode_chunk 1, 4 and 8 with
    overlap on and off;
  * a prefix-cache hit identical to the cold run; pad writes of a hit
    prefix near the full context stay in scratch;
  * page exhaustion queues, then flows; overload sheds with
    EngineOverloadError's fields; EOS mid-chunk and cancel (queued,
    running, mid-chunk) retire at the right token;
  * the family count bounded by the buckets; the arena written in place;
  * every knob out of this slice raises NotImplementedError naming its
    ROADMAP item; create_engine serves a saved model with disable_gpu()
    and raises on a GPU config without a GPU;
  * the new modules import neither jax nor paddle_tpu.

Where a port stream differs from JAX's, `_same_or_near_tie` requires the
first differing token to be a near-tie in JAX's own scores (top-2
margin under 1e-5), and the test names the stream and position.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import gpt_decode as gd
from paddle_tpu.models.gpt import GPTConfig, gpt_lm_program
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch.models import gpt_decode as tgd
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.serving import (EngineOverloadError, FaultPlan,
                                      ServingConfig, ServingEngine,
                                      SlotKVCache)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIE = 1e-5
TOP_K = 5


def _cfg(mod):
    return mod(vocab_size=97, hidden=32, layers=2, heads=4, max_pos=64,
               dropout=0.0, attn_impl="xla")


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 97, (n,)).astype(np.int32) for n in lens]


P3 = _prompts(2, (3, 5, 7))
P10 = _prompts(11, (2, 3, 4, 5, 6, 7, 8, 3, 5, 7))
PFX = _prompts(22, (8,))[0]


def _p10_kw(i):
    """Request i of P10: even ones greedy, odd ones seeded."""
    return {"temperature": 0.0 if i % 2 == 0 else 0.8, "seed": 100 + i}


def _drain(eng, prompts, max_new, kws):
    reqs = [eng.submit(p, max_new, **kw) for p, kw in zip(prompts, kws)]
    eng.run_until_drained()
    return [r.output() for r in reqs]


@pytest.fixture(scope="module")
def world():
    """Params on both sides and the JAX engine's reference streams."""
    cfg = _cfg(GPTConfig)
    with pt.unique_name_guard():
        main, startup, _ = gpt_lm_program(cfg, 8, is_test=True)
    exe = pt.Executor()
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        jp = gd.collect_gpt_params(scope, cfg)
    arrays = {v.name: np.asarray(scope.find_var(v.name))
              for v in main.list_vars() if v.persistable
              and scope.find_var(v.name) is not None}
    tscope = ptt.Scope()
    ptt.io.set_params_from_numpy(tscope, arrays, "cpu")
    tcfg = _cfg(TGPTConfig)
    tp = tgd.collect_gpt_params(tscope, tcfg)
    jeng = JServingEngine(jp, cfg, JServingConfig(
        num_slots=2, max_queue=16, prefill_buckets=(4, 8), max_len=32,
        top_k=TOP_K))
    seeded = {"temperature": 0.8, "seed": 11}
    refs = {"p3_greedy": jeng.generate(P3, 6),
            "p3_seeded": jeng.generate(P3, 6, **seeded),
            "p10": _drain(jeng, P10, 6, [_p10_kw(i) for i in range(10)]),
            "pfx_greedy": jeng.generate([PFX], 9)[0],
            "pfx_seeded": jeng.generate([PFX], 9, temperature=0.8,
                                        seed=7)[0]}
    return {"cfg": cfg, "jp": jp, "tcfg": tcfg, "tp": tp, "refs": refs,
            "arrays": arrays, "main": main}


def make_engine(world, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_queue", 16)
    kw.setdefault("prefill_buckets", (4, 8))
    kw.setdefault("max_len", 32)
    return ServingEngine(world["tp"], world["tcfg"], ServingConfig(**kw))


def sequential_ref(world, prompt, max_new):
    return tgd.gpt_generate(world["tp"], world["tcfg"],
                            np.asarray(prompt)[None], max_new)[0]


def _jax_scores(world, seq, p_len, i, temperature, seed):
    """JAX's scores for generated token i of `seq`: the logits for a
    greedy draw, logits / temp + the token's Gumbel noise for a seeded
    one (its key is split i times from the request seed), top-k first."""
    import jax.numpy as jnp
    logits = np.asarray(gd.gpt_forward_logits(
        world["jp"], world["cfg"], seq[None, :p_len + i]))[0, -1]
    if temperature == 0.0:
        return logits
    key = gd.sample_key(np.uint32(seed))
    for _ in range(i):
        key = gd.sample_split(key)
    scaled = logits / np.float32(temperature)
    top = np.sort(scaled)[::-1][:TOP_K]
    return top + np.asarray(gd.sample_gumbel(jnp.asarray(key), TOP_K))


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


# -- token streams against the JAX engine -----------------------------------

def test_three_prompts_two_slots_match_jax(world):
    refs = world["refs"]
    eng = make_engine(world, top_k=TOP_K)
    for name, kw in (("p3_greedy", {}),
                     ("p3_seeded", {"temperature": 0.8, "seed": 11})):
        outs = eng.generate(P3, 6, **kw)
        for j, (p, a, b) in enumerate(zip(P3, refs[name], outs)):
            _same_or_near_tie(world, a, b, p.size, name=f"{name}[{j}]",
                              **kw)
    s = eng.stats()
    assert s["completed"] == 6 and s["active_slots"] == 0
    assert s["free_slots"] == 2


@pytest.mark.parametrize("chunk,overlap", [(1, True), (1, False),
                                           (4, True), (4, False),
                                           (8, True), (8, False)])
def test_ten_concurrent_match_jax_at_every_chunk(world, chunk, overlap):
    """10 concurrent requests, greedy and seeded, on 4 slots: the JAX
    engine's streams (2 slots) at every chunk size, overlap on or off."""
    eng = make_engine(world, num_slots=4, top_k=TOP_K, decode_chunk=chunk,
                      overlap=overlap)
    kws = [_p10_kw(i) for i in range(10)]
    outs = _drain(eng, P10, 6, kws)
    for i, (p, a, b) in enumerate(zip(P10, world["refs"]["p10"], outs)):
        _same_or_near_tie(world, a, b, p.size, name=f"p10[{i}]", **kws[i])
    events = eng.scheduler.compile_events
    assert events.count("decode_chunk") == 1, events
    assert eng.scheduler.compile_count <= len(eng.buckets) + 2
    if overlap:
        assert eng.scheduler.inflight_count <= 1
    else:
        assert eng.scheduler.inflight_count == 0


def test_prefix_cache_hit_identical_to_cold(world):
    """A prompt re-admitted after its prefix block went to the LRU pool
    maps it back (a hit) and emits the cold run's stream, greedy and
    seeded — and JAX's."""
    refs = world["refs"]
    for name, kw in (("pfx_greedy", {}),
                     ("pfx_seeded", {"temperature": 0.8, "seed": 7})):
        eng = make_engine(world, block_size=4, top_k=TOP_K)
        (cold,) = eng.generate([PFX], 9, **kw)
        assert eng.kv.prefix_hits == 0 and eng.kv.blocks_cached == 2
        (warm,) = eng.generate([PFX], 9, **kw)
        assert eng.kv.prefix_hits == 1 == eng.stats()["prefix_hits"]
        np.testing.assert_array_equal(warm, cold)
        _same_or_near_tie(world, refs[name], warm, PFX.size, name=name,
                          **kw)


def test_prefix_hit_near_full_context_pad_writes_stay_in_scratch(world):
    """With a large hit prefix and a small suffix bucket the padded
    suffix runs past max_pages*block_size; pad writes must land in
    scratch, never on a real K/V row, keeping the warm stream exact."""
    rng = np.random.RandomState(29)
    p = rng.randint(0, 97, (30,)).astype(np.int32)
    eng = make_engine(world, prefill_buckets=(8, 32), block_size=4,
                      max_len=32)
    (cold,) = eng.generate([p], 2)
    (warm,) = eng.generate([p], 2)
    assert eng.kv.prefix_hits == 7       # pfx 28, suffix 2 -> bucket 8
    np.testing.assert_array_equal(warm, cold)
    np.testing.assert_array_equal(warm, sequential_ref(world, p, 2))


# -- admission, overload, EOS, cancel ---------------------------------------

def test_pages_exhausted_queues_then_flows(world):
    prompts = _prompts(26, (6, 6, 6, 6))
    # 4 requests x 2 blocks each, arena of 4 blocks: 2 concurrent max
    eng = make_engine(world, num_slots=4, block_size=8, kv_blocks=5,
                      max_len=16)
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.step()
    assert eng.kv.active_count == 2          # pages, not slots, bound it
    assert eng.stats()["queue_depth"] == 2
    eng.run_until_drained()
    assert all(r.finished for r in reqs)
    assert eng.stats()["shed"] == 0 and eng.kv.blocks_used == 0
    for r, p in zip(reqs, prompts):
        np.testing.assert_array_equal(r.output(),
                                      sequential_ref(world, p, 5))


def test_forced_page_shortage_requeues(world):
    eng = make_engine(world, fault_plan=FaultPlan(page_shortages=[0]))
    req = eng.submit(P3[0], max_new_tokens=3)
    eng.step()                               # denied: requeued
    assert req.state == "queued" and eng.faults.denied_steps == 1
    eng.run_until_drained()
    np.testing.assert_array_equal(req.output(),
                                  sequential_ref(world, P3[0], 3))


def test_overload_sheds_with_structured_fields(world):
    eng = make_engine(world, num_slots=1, max_queue=1)
    p = np.asarray([1, 2, 3], np.int32)
    eng.submit(p, max_new_tokens=2)
    with pytest.raises(EngineOverloadError) as ei:
        eng.submit(p, max_new_tokens=2)
    assert ei.value.queue_depth == 1 and ei.value.running == 0
    assert ei.value.retry_after_s == ptt.serving.DEFAULT_RETRY_AFTER_S
    eng.run_until_drained()
    eng.submit(p, max_new_tokens=8)
    eng.step()                               # admit: occupies the slot
    eng.submit(p, max_new_tokens=2)          # queue full again
    with pytest.raises(EngineOverloadError) as ei:
        eng.submit(p, max_new_tokens=2)
    assert ei.value.queue_depth == 1 and ei.value.running == 1
    assert ei.value.retry_after_s == eng.metrics.queue_wait_p50()
    eng.run_until_drained()
    s = eng.stats()
    assert s["shed"] == 2 and s["completed"] == 3


def test_submit_validation(world):
    eng = make_engine(world)
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(np.arange(9, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.arange(8, dtype=np.int32), max_new_tokens=30)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros((0,), np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="adapter"):
        eng.submit(np.asarray([1], np.int32), 2, adapter_id=1)
    assert eng.stats()["submitted"] == 0


@pytest.mark.parametrize("chunk", [1, 8])
def test_eos_retires_at_the_eos_token(world, chunk):
    """EOS mid-chunk freezes the slot on the device and retires it at
    exactly the EOS token; the slot frees."""
    rng = np.random.RandomState(7)
    k = None
    for _ in range(20):
        p = rng.randint(0, 97, (3,)).astype(np.int32)
        gen = list(sequential_ref(world, p, 12)[3:])
        k = next((i for i in range(1, len(gen)) if gen[i] not in gen[:i]),
                 None)
        if k is not None and k % 8 != 7:
            break
    assert k is not None, "no usable greedy stream found"
    eng = make_engine(world, decode_chunk=chunk)
    req = eng.submit(p, max_new_tokens=12, eos_id=int(gen[k]))
    eng.run_until_drained()
    assert req.finished and len(req.tokens) == k + 1
    assert req.tokens[-1] == gen[k]
    assert eng.stats()["free_slots"] == eng.kv.num_slots


def test_cancel_queued_running_and_mid_chunk(world):
    eng = make_engine(world, num_slots=1, decode_chunk=4)
    p = np.asarray([1, 2, 3], np.int32)
    a = eng.submit(p, max_new_tokens=20)
    b = eng.submit(p, max_new_tokens=8)
    eng.step()                   # a admitted + launched, b queued
    assert eng.cancel(b) and b.state == "cancelled"
    eng.step()                   # launch k+1, collect k
    n_a = len(a.tokens)
    assert eng.cancel(a) and a.state == "cancelled"
    assert not eng.cancel(a)
    eng.run_until_drained()
    assert len(a.tokens) == n_a and b.tokens == []
    assert eng.kv.free_count == 1 and eng.kv.blocks_used == 0
    assert "release_slot" in eng.scheduler.compile_events
    # the released slot and its pages serve a new request exactly
    p2 = _prompts(12, (5,))[0]
    (out,) = eng.generate([p2], 6)
    np.testing.assert_array_equal(out, sequential_ref(world, p2, 6))


def test_streaming_callback_and_metrics(world):
    got = []
    eng = make_engine(world)
    req = eng.submit(P3[1], max_new_tokens=5,
                     on_token=lambda r, tok: got.append((r, tok)))
    eng.run_until_drained()
    assert [t for _, t in got] == req.tokens
    assert all(r is req for r, _ in got)
    s = eng.stats()
    assert s["tokens_out"] == 5 and s["prefills"] == 1
    assert s["decode_steps"] == 1            # 4 tokens in one chunk
    assert s["mean_tokens_per_dispatch"] == pytest.approx(4.0)
    assert s["mean_ttft"] >= 0 and s["mean_tpot"] >= 0
    eng.close()


# -- compile discipline and in-place state -----------------------------------

def test_family_count_bounded_by_buckets(world):
    eng = make_engine(world, num_slots=8, block_size=4)
    eng.generate(P10, 5)
    eng.generate(P10[:3], 5)             # prefix hits: smaller buckets
    events = eng.scheduler.compile_events
    assert eng.scheduler.compile_count <= len(eng.buckets) + 2, events
    assert eng.stats()["compiled_executables"] == \
        eng.scheduler.compile_count
    assert {e for e in events if e.startswith("prefill")} \
        <= {"prefill:L4", "prefill:L8"}
    assert events.count("decode_chunk") == 1
    assert events.count("admit_sample") == 1


def test_arena_and_state_written_in_place(world):
    eng = make_engine(world, decode_chunk=2)
    arena, pt_ = eng.kv.kv, eng.scheduler._pt
    ptrs = (arena.data_ptr(), pt_.data_ptr())
    eng.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=8)
    for _ in range(3):
        eng.step()
        assert eng.kv.kv is arena and eng.scheduler._pt is pt_
        assert (arena.data_ptr(), pt_.data_ptr()) == ptrs
    eng.submit(np.asarray([4, 5], np.int32), max_new_tokens=2)
    eng.run_until_drained()
    assert eng.kv.kv is arena and arena.data_ptr() == ptrs[0]
    assert eng.stats()["completed"] == 2


# -- the observability knobs --------------------------------------------------

def test_tick_profile_and_dispatch_timing(world):
    eng = make_engine(world, tick_profile=True, dispatch_timing=True)
    eng.generate(P3, 4)
    ring = eng.tick_records()
    assert ring and all(set(r["phases"]) == set(
        ptt.serving.metrics._TICK_PHASES) for r in ring)
    assert all(abs(sum(r["phases"].values()) - r["wall_s"]) < 1e-9
               for r in ring)
    snap = eng.compile_journal.snapshot()
    assert set(snap["families"]) == set(eng.scheduler.compile_events)
    assert snap["mfu_proxy"] is None          # no static cost analysis
    s = eng.stats()
    assert s["p50_dispatch_host"] is not None
    assert s["p50_dispatch_device"] is not None
    eng.close()


# -- knobs out of this slice ---------------------------------------------------

@pytest.mark.parametrize("knob,item", [
    ({"preempt": True}, "A.1.2"),
    ({"preempt_policy": "oldest"}, "A.1.2"),
    ({"speculate_k": 2}, "A.1.3"),
    ({"speculate_ngram": 64}, "A.1.3"),
    ({"weight_dtype": "int8"}, "A.1.4"),
    ({"kv_dtype": "int8"}, "A.1.4"),
    ({"max_adapters": 4, "adapter_rank": 2}, "A.1.5"),
    ({"mesh_shape": (2,)}, "A.8"),
])
def test_knobs_out_of_this_slice_raise(knob, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ServingConfig(**knob)


def test_create_engine_and_kv_cache_knobs_out_of_this_slice_raise(world):
    cfg = world["tcfg"]
    with pytest.raises(NotImplementedError, match="ROADMAP A.1.4"):
        ptt.inference.create_engine("unused", cfg, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP A.11"):
        ptt.inference.create_engine("unused", cfg, debug_port=0)
    with pytest.raises(NotImplementedError, match="ROADMAP A.1.4"):
        SlotKVCache(cfg, 2, 16, kv_dtype="int8")
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        SlotKVCache(cfg, 2, 16, mesh_shards=2)


# -- the entry point -------------------------------------------------------------

def test_create_engine_from_saved_model(world, tmp_path):
    """A model dir the JAX package saves serves on the CPU through
    create_engine with disable_gpu(); a GPU config raises here."""
    cfg = world["cfg"]
    exe = pt.Executor()
    scope = pt.Scope()
    with pt.scope_guard(scope):
        for name, arr in world["arrays"].items():
            scope.set_var(name, arr)
        with pt.unique_name_guard():
            main, _, fetches = gpt_lm_program(cfg, 8, is_test=True)
        pt.io.save_inference_model(str(tmp_path), ["tokens"],
                                   [fetches["logits"]], exe,
                                   main_program=main)
    conf = ptt.inference.Config(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        ptt.inference.create_engine(conf, world["tcfg"])
    conf.disable_gpu()
    eng = ptt.inference.create_engine(
        conf, world["tcfg"], ServingConfig(num_slots=2,
                                           prefill_buckets=(4, 8),
                                           max_len=32))
    assert eng.device.type == "cpu" and eng.kv.kv.device.type == "cpu"
    outs = eng.generate(P3[:2], 4)
    for p, o in zip(P3[:2], outs):
        np.testing.assert_array_equal(o, sequential_ref(world, p, 4))


_NEW_MODULES = ("models/gpt_decode.py", "profiler.py", "serving/__init__.py",
                "serving/engine.py", "serving/faults.py",
                "serving/kv_cache.py", "serving/metrics.py",
                "serving/scheduler.py", "observability/__init__.py",
                "observability/export.py", "observability/metrics.py",
                "observability/request_log.py",
                "observability/watchdog.py", "inference/__init__.py")


def test_new_modules_import_neither_jax_nor_paddle_tpu():
    """Statically: no import statement of the slice's modules names jax
    or paddle_tpu. Dynamically: importing them and serving a request
    loads neither."""
    for rel in _NEW_MODULES:
        path = os.path.join(ROOT, "paddle_tpu_torch", rel)
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "paddle_tpu"), \
                    f"{rel} imports {n}"
    code = (
        "import sys, numpy as np\n"
        "import paddle_tpu_torch as ptt\n"
        "from paddle_tpu_torch.models.gpt import GPTConfig\n"
        "from paddle_tpu_torch.models import gpt_decode as gd\n"
        "from paddle_tpu_torch.serving import ServingEngine, "
        "ServingConfig\n"
        "cfg = GPTConfig(vocab_size=97, hidden=32, layers=1, heads=4,"
        " max_pos=32, dropout=0.0)\n"
        "main, startup, _ = ptt.models.gpt.gpt_lm_program(cfg, 8,"
        " is_test=True)\n"
        "sc = ptt.Scope()\n"
        "ptt.Executor(ptt.CPUPlace()).run(startup, scope=sc)\n"
        "eng = ServingEngine(gd.collect_gpt_params(sc, cfg), cfg,"
        " ServingConfig(num_slots=2, prefill_buckets=(8,), max_len=16))\n"
        "print(len(eng.generate([np.arange(3)], 4, temperature=0.5)[0]))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout and r.stdout.startswith("7"), r.stdout
