"""Quantized serving in the PyTorch port (`ServingConfig(weight_dtype=
"int8", kv_dtype="int8")`, `inference.create_engine(dtype=
torch.bfloat16)`) against the JAX package's, on the CPU, on the tiny GPT
of tests/test_torch_serving.py (vocab 97, hidden 32, 2 layers, 2 slots,
buckets 4 and 8, max_len 32). Mirrors tests/test_serving.py's quantized
tests without a mesh:

  * quantize_params and _quantize_rows: int8 codes and f32 scales
    bitwise JAX's, exact .5 ties and zero channels included;
  * int8 weights, int8 KV and both: greedy and seeded streams equal the
    JAX engine's at decode_chunk 8 and 4, overlap on and off, with
    speculate_k > 0, through preemption and resume, and through
    migration port -> JAX and JAX -> port with an int8 ticket;
  * the int8 arena's rows are the plain _quantize_rows of the fp32 rows
    (data and scale plane), written in place; a shared prefix block
    maps the same codes and scales;
  * pool_bytes and weight_bytes equal JAX's exactly; the gauges report
    the served dtypes; dtype, scale-plane and coverage rejects;
  * create_engine(dtype=torch.bfloat16) serves a bf16 copy on a bf16
    arena, its bytes equal JAX's and its greedy streams JAX's.

Where a port stream differs from JAX's, `_same_or_near_tie` requires the
first differing token to be a near-tie (top-2 margin under 1e-5) in
JAX's own scores, taken through JAX's paged prefill with the engine's
params and arena dtype (so an int8 arena's rows are quantized there
exactly as the engine quantizes them).
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
from paddle_tpu_torch.serving import (MigrationTicket, ServingConfig,
                                      ServingEngine, SlotKVCache,
                                      TicketError)
from test_torch_serving import _close_engines, _opened  # noqa: F401
from torch_port_common import one_torch_thread  # noqa: F401


TIE = 1e-5
MODES = {"int8w": {"weight_dtype": "int8"},
         "int8kv": {"kv_dtype": "int8"},
         "int8w_int8kv": {"weight_dtype": "int8", "kv_dtype": "int8"}}
# tests/test_serving.py's PRESSURE: 4 requests of up to 5 blocks against
# 11 allocatable, so the engine must preempt to flow
PRESSURE = dict(num_slots=4, block_size=4, kv_blocks=12, decode_chunk=4,
                preempt=True)


def _cfg(mod):
    return mod(vocab_size=97, hidden=32, layers=2, heads=4, max_pos=64,
               dropout=0.0, attn_impl="xla")


_RNG = np.random.RandomState(5)
MIX = [_RNG.randint(0, 97, (n,)).astype(np.int32)
       for n in (3, 5, 7, 4, 6, 8)]


def _mix_kw(i):
    return {"temperature": 0.0 if i % 2 == 0 else 0.8, "seed": 40 + i}


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
    return {"cfg": cfg, "jp": jp, "tcfg": tcfg, "arrays": arrays,
            "tp": tgd.collect_gpt_params(tscope, tcfg), "refs": {}}


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


def _run_mix(eng, prompts=MIX, max_new=8):
    reqs = [eng.submit(p, max_new, **_mix_kw(i))
            for i, p in enumerate(prompts)]
    eng.run_until_drained()
    return [r.output() for r in reqs]


def jax_ref(world, mode, **kw):
    """The JAX engine's streams of MIX at `mode` (memoized a module)."""
    key = (mode, tuple(sorted(kw.items())))
    if key not in world["refs"]:
        eng = make_jax_engine(world, **MODES[mode], **kw)
        world["refs"][key] = (_run_mix(eng), eng.stats(),
                              eng.scheduler.spec_proposed,
                              eng.scheduler.spec_accepted)
        eng.close()
    return world["refs"][key]


def _jax_scores(world, mode, seq, p_len, i, temperature, seed):
    """JAX's scores for generated token i of `seq` under `mode`: the
    last-position logits of a paged prefill of seq[:p_len + i] with the
    engine's params and arena dtype (an int8 arena quantizes every row
    at its scatter, as the engine does), plus the token's Gumbel noise
    for a seeded draw."""
    import jax.numpy as jnp
    cfg = world["cfg"]
    params = gd.quantize_params(world["jp"], cfg) \
        if MODES[mode].get("weight_dtype") else world["jp"]
    n = p_len + i
    bs = 4
    pages = -(-n // bs)
    data = jnp.zeros((cfg.layers, 2, pages + 1, cfg.heads, bs,
                      cfg.hidden // cfg.heads), jnp.float32)
    arena = (data.astype(jnp.int8), jnp.zeros(data.shape[:-1],
                                               jnp.float32)) \
        if MODES[mode].get("kv_dtype") else data
    logits, _ = gd.gpt_prefill_pages(
        params, cfg, jnp.asarray(seq[None, :n], jnp.int32), 0, n, arena,
        jnp.arange(1, pages + 1, dtype=jnp.int32))
    logits = np.asarray(logits[0])
    if temperature == 0.0:
        return logits
    key = gd.sample_key(np.uint32(seed))
    for _ in range(i):
        key = gd.sample_split(key)
    scaled = logits / np.float32(temperature)
    return scaled + np.asarray(gd.sample_gumbel(jnp.asarray(key),
                                                scaled.size))


def _same_or_near_tie(world, mode, jax_out, port_out, p_len,
                      temperature=0.0, seed=0, name=""):
    """Port stream == JAX stream, or the first differing token is a
    near-tie in JAX's scores (top-2 margin < TIE)."""
    jax_out, port_out = np.asarray(jax_out), np.asarray(port_out)
    assert jax_out.shape == port_out.shape, name
    diff = np.nonzero(jax_out != port_out)[0]
    if not diff.size:
        return
    i = int(diff[0]) - p_len
    assert i >= 0, f"{name}: prompt differs"
    s = np.sort(_jax_scores(world, mode, jax_out, p_len, i, temperature,
                            seed))[::-1]
    assert s[0] - s[1] < TIE, (
        f"{name}: stream differs from JAX's at generated token {i} "
        f"(margin {s[0] - s[1]} is no near-tie)")


def _hold_to_jax(world, mode, refs, outs, name):
    for i, (p, a, b) in enumerate(zip(MIX, refs, outs)):
        _same_or_near_tie(world, mode, a, b, p.size, name=f"{name}[{i}]",
                          **_mix_kw(i))


# -- codes and scales ---------------------------------------------------------

def test_quantize_params_codes_and_scales_bitwise(world):
    """quantize_params on the model's weights, and on a weight built to
    sit on exact .5 rounding ties with a zero channel: the int8 codes
    and f32 scales are JAX's bit for bit; embeddings, LNs and biases are
    the same tensors."""
    cfg, tcfg = world["cfg"], world["tcfg"]
    jq = gd.quantize_params(world["jp"], cfg)
    tq = tgd.quantize_params(world["tp"], tcfg)
    assert tq["wte"] is world["tp"]["wte"]
    for jb, tb, b in zip(jq["blocks"], tq["blocks"], world["tp"]["blocks"]):
        assert tb["ln1"] is b["ln1"]
        for nm in tgd.ADAPTER_PROJECTIONS:
            assert tb[nm]["w_q"].dtype == torch.int8
            assert tb[nm]["w_s"].dtype == torch.float32
            assert tb[nm]["b"] is b[nm]["b"]
            np.testing.assert_array_equal(tb[nm]["w_q"].numpy(),
                                          np.asarray(jb[nm]["w_q"]))
            np.testing.assert_array_equal(tb[nm]["w_s"].numpy(),
                                          np.asarray(jb[nm]["w_s"]))
    # ties: w = (k + 0.5) * s / 127 with s the channel's abs-max
    rng = np.random.RandomState(3)
    s = rng.uniform(0.1, 2.0, (16,)).astype(np.float32)
    k = rng.randint(-126, 126, (24, 16)).astype(np.float32)
    w = ((k + 0.5) * s / 127.0).astype(np.float32)
    w[0] = s
    w[:, 5] = 0.0
    one = {"wte": world["tp"]["wte"], "wpe": world["tp"]["wpe"],
           "lnf": world["tp"]["lnf"], "blocks": [
               {"ln1": None, "ln2": None,
                **{nm: {"w": torch.from_numpy(w), "b": None}
                   for nm in tgd.ADAPTER_PROJECTIONS}}]}
    jone = {"wte": None, "wpe": None, "lnf": None, "blocks": [
        {"ln1": None, "ln2": None,
         **{nm: {"w": w, "b": None} for nm in tgd.ADAPTER_PROJECTIONS}}]}
    tb = tgd.quantize_params(one, tcfg)["blocks"][0]["q"]
    jb = gd.quantize_params(jone, cfg)["blocks"][0]["q"]
    np.testing.assert_array_equal(tb["w_q"].numpy(), np.asarray(jb["w_q"]))
    np.testing.assert_array_equal(tb["w_s"].numpy(), np.asarray(jb["w_s"]))
    assert (tb["w_q"].numpy()[:, 5] == 0).all()


@pytest.mark.parametrize("scale", [1e-3, 1.0, 40.0])
def test_quantize_rows_bitwise(scale):
    """_quantize_rows over (rows, heads, hd) K/V values: codes and
    per-(row, head) scales bitwise JAX's, zero rows included."""
    import jax.numpy as jnp
    rng = np.random.RandomState(int(scale * 1000))
    v = (rng.randn(37, 4, 8) * scale).astype(np.float32)
    v[3] = 0.0
    v[7, 2] = (np.arange(8) - 3.5).astype(np.float32)    # .5 ties
    jq, js = gd._quantize_rows(jnp.asarray(v))
    tq, ts = tgd._quantize_rows(torch.from_numpy(v))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tq.numpy()[3] == 0).all() and (ts.numpy()[3] == 0).all()


# -- streams against the JAX engine -------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("chunk,overlap", [(8, True), (8, False),
                                           (4, True), (4, False)])
def test_quantized_streams_match_jax(world, mode, chunk, overlap):
    """Greedy and seeded streams of every quantized mode equal the JAX
    engine's at each chunk size, overlap on and off; the family count
    stays len(buckets) + 2."""
    refs, jstats, _, _ = jax_ref(world, mode)
    eng = make_engine(world, decode_chunk=chunk, overlap=overlap,
                      **MODES[mode])
    outs = _run_mix(eng)
    _hold_to_jax(world, mode, refs, outs, f"{mode} k{chunk}")
    s = eng.stats()
    assert s["kv_dtype"] == jstats["kv_dtype"]
    assert s["weight_dtype"] == jstats["weight_dtype"]
    assert eng.scheduler.compile_events.count("decode_chunk") == 1
    assert eng.scheduler.compile_count <= len(eng.buckets) + 2
    eng.close()


@pytest.mark.parametrize("mode", ["int8kv", "int8w_int8kv"])
def test_quantized_spec_streams_match_jax(world, mode):
    """speculate_k = 3 on an int8 arena (the verify pass's dequant
    path): the JAX engine's streams and acceptance counts at the same
    k, and the port's own k = 0 streams."""
    refs, _, j_prop, j_acc = jax_ref(world, mode, speculate_k=3)
    eng = make_engine(world, speculate_k=3, **MODES[mode])
    outs = _run_mix(eng)
    _hold_to_jax(world, mode, refs, outs, f"{mode} spec")
    assert eng.scheduler.spec_proposed == j_prop > 0
    assert eng.scheduler.spec_accepted == j_acc
    base = _run_mix(make_engine(world, **MODES[mode]))
    assert [list(o) for o in outs] == [list(o) for o in base]


def test_quantized_preempt_resume_matches_jax(world):
    """An int8-weight int8-KV engine over an arena that must preempt:
    the payload and its scale-plane rows round-trip host memory, every
    stream equals the JAX engine's unpressured one, and the drain leaks
    neither blocks nor swap bytes."""
    mode = "int8w_int8kv"
    refs, _, _, _ = jax_ref(world, mode)
    eng = make_engine(world, **PRESSURE, **MODES[mode])
    arena = (eng.kv.kv.data_ptr(), eng.kv.kv_scales.data_ptr())
    outs = _run_mix(eng)
    s = eng.stats()
    assert s["preemptions"] >= 1, "arena not tight enough to preempt"
    _hold_to_jax(world, mode, refs, outs, "preempt")
    assert s["blocks_used"] == 0 and s["swap_pool_bytes"] == 0
    assert (eng.kv.kv.data_ptr(), eng.kv.kv_scales.data_ptr()) == arena


def _rewrap(ticket, cls):
    """The ticket as the receiving package rebuilds it from the sender's
    fields and checksum."""
    fields = {f: getattr(ticket, f) for f in (
        "prompt", "max_new", "temperature", "seed", "eos_id", "tokens",
        "request_id", "pos", "produced", "seq", "length", "n_blocks",
        "block_size", "payload", "token", "ts", "remaining", "temp", "eos",
        "key_row", "spec", "tenant", "rerouted_from", "slo_stamps",
        "version", "checksum", "created_unix", "mesh_shape", "scales",
        "adapter_id", "adapter_digest")}
    return cls(**fields)


def _drive(eng, req, n=2):
    while len(req.tokens) < n:
        eng.step()
    assert not req.finished


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("temp,seed", [(0.0, 0), (0.8, 5)])
def test_int8_ticket_crosses_packages(world, direction, temp, seed):
    """An int8-KV sequence migrates between the packages: the ticket
    carries the int8 payload and its f32 scale-plane rows, verifies
    under the other package's class with the sender's checksum, and the
    stream finishes as the receiver's never-migrated run does."""
    mode = "int8w_int8kv"
    p = np.asarray([3, 1, 4, 1, 5], np.int32)
    mk_src, mk_dst, cls = (make_engine, make_jax_engine, JMigrationTicket) \
        if direction == "port_to_jax" \
        else (make_jax_engine, make_engine, MigrationTicket)
    src = mk_src(world, decode_chunk=4, max_len=48, **MODES[mode])
    stream = []
    req = src.submit(p, 30, temperature=temp, seed=seed,
                     on_token=lambda r, t: stream.append(t))
    _drive(src, req)
    t = src.migrate_out(req)
    assert t.payload.dtype == np.int8 and t.scales.dtype == np.float32
    assert t.scales.shape == t.payload.shape[:5]
    assert t.swap_bytes == t.payload.nbytes + t.scales.nbytes
    ticket = _rewrap(t, cls)
    assert ticket.verify() and ticket.checksum == t.checksum
    dst = mk_dst(world, decode_chunk=4, max_len=48, **MODES[mode])
    req2 = dst.migrate_in(ticket, on_token=lambda r, t: stream.append(t))
    dst.run_until_drained()
    src.run_until_drained()
    assert req2.state == "finished" and len(stream) == 30
    ref = mk_dst(world, decode_chunk=4, max_len=48, **MODES[mode])
    full = []
    ref.submit(p, 30, temperature=temp, seed=seed,
               on_token=lambda r, t: full.append(t))
    ref.run_until_drained()
    jax_full = full if direction == "port_to_jax" else stream
    port_full = stream if direction == "port_to_jax" else full
    _same_or_near_tie(world, mode, np.concatenate([p, jax_full]),
                      np.concatenate([p, port_full]), p.size, temp, seed,
                      name=direction)
    s = dst.stats()
    assert s["blocks_used"] == 0 and s["swapped_slots"] == 0


def test_int8_ticket_rejects(world):
    """Dtype mismatches reject whole, both ways (an fp32 ticket on an
    int8 arena and an int8 one on an fp32 arena), a JAX fp32 ticket too;
    a tampered scale plane fails the checksum; nothing is mutated on the
    refusing engine and the intact ticket still adopts."""
    p = np.asarray([3, 1, 4, 1, 5], np.int32)
    q8 = make_engine(world, max_len=48, kv_dtype="int8")
    f32 = make_engine(world, max_len=48)
    rq = q8.submit(p, 20)
    rf = f32.submit(p, 20)
    _drive(q8, rq)
    _drive(f32, rf)
    tq, tf = q8.migrate_out(rq), f32.migrate_out(rf)
    with pytest.raises(TicketError, match="dtype"):
        make_engine(world, max_len=48).migrate_in(tq)
    with pytest.raises(TicketError, match="dtype"):
        make_engine(world, max_len=48, kv_dtype="int8").migrate_in(tf)
    jf = make_jax_engine(world, max_len=48)
    jr = jf.submit(p, 20)
    _drive(jf, jr)
    jt = _rewrap(jf.migrate_out(jr), MigrationTicket)
    dst = make_engine(world, max_len=48, kv_dtype="int8")
    with pytest.raises(TicketError, match="dtype"):
        dst.migrate_in(jt)
    good = tq.scales
    tq.scales = good.copy()
    tq.scales[0, 0, 0, 0, 0] += 1.0
    assert not tq.verify()
    with pytest.raises(TicketError, match="checksum"):
        dst.migrate_in(tq)
    s = dst.stats()
    assert s["swapped_slots"] == 0 and s["blocks_used"] == 0
    tq.scales = good
    req = dst.migrate_in(tq)
    dst.run_until_drained()
    assert req.state == "finished" and len(req.tokens) == 20


# -- the arena ---------------------------------------------------------------

def test_int8_arena_rows_are_quantized_fp32_rows(world):
    """After one prompt's prefill, the int8 engine's layer-0 arena codes
    and scales for the prompt's rows equal bitwise the plain
    _quantize_rows of the fp32-arena engine's rows for the same prompt
    (int8 weights on both, so layer 0's K/V are the same values; later
    layers read dequantized attention and differ by design); every
    layer's scale plane is written for those rows; both tensors keep
    their storage."""
    p = MIX[5]
    qe = make_engine(world, kv_dtype="int8", weight_dtype="int8")
    fe = make_engine(world, weight_dtype="int8")
    ptrs = (qe.kv.kv.data_ptr(), qe.kv.kv_scales.data_ptr())
    for e in (qe, fe):
        e.submit(p, 1)
        e.run_until_drained()
    n = p.size                     # the prompt's rows, in block 1
    q, s = tgd._quantize_rows(fe.kv.kv[0, :, 1, :, :n].transpose(1, 2))
    np.testing.assert_array_equal(
        qe.kv.kv[0, :, 1, :, :n].transpose(1, 2).numpy(), q.numpy())
    np.testing.assert_array_equal(
        qe.kv.kv_scales[0, :, 1, :, :n].transpose(1, 2).numpy(),
        s.numpy())
    assert (qe.kv.kv_scales[:, :, 1, :, :n] > 0).all()
    assert (qe.kv.kv.data_ptr(), qe.kv.kv_scales.data_ptr()) == ptrs


def test_int8_prefix_cache_shares_codes_and_scales(world):
    """A second request hash-hitting the first's prompt blocks on an int8
    arena maps the same codes and scale-plane entries: its stream equals
    a cold (cache-off) run of the same requests."""
    sys_prompt = np.arange(1, 9, dtype=np.int32)
    prompts = [np.concatenate([sys_prompt, np.asarray(t, np.int32)])
               for t in ([13, 17], [19, 23])]

    def run(prefix_cache):
        eng = make_engine(world, block_size=4, prefix_cache=prefix_cache,
                          prefill_buckets=(4, 16), kv_dtype="int8",
                          weight_dtype="int8")
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.run_until_drained()
        return [r.tokens for r in reqs], eng.stats()

    cold, s_cold = run(False)
    warm, s_warm = run(True)
    assert s_cold["prefix_hits"] == 0 and s_warm["prefix_hits"] > 0
    assert warm == cold


# -- bytes, gauges and validation ---------------------------------------------

@pytest.mark.parametrize("mode", [None] + list(MODES))
def test_pool_and_weight_bytes_equal_jax(world, mode):
    """pool_bytes (int8 data + the f32 scale plane) and weight_bytes (int8
    weights + their scales + the rest) equal the JAX engine's exactly;
    the serving_kv_dtype_bytes / serving_weight_bytes gauges and /varz's
    mesh rollup report them."""
    from paddle_tpu_torch.observability import get_registry
    from paddle_tpu_torch.observability.debug_server import _serving_varz
    kw = MODES[mode] if mode else {}
    j = make_jax_engine(world, **kw)
    t = make_engine(world, **kw)
    js, ts = j.stats(), t.stats()
    for key in ("pool_bytes", "hbm_per_chip_bytes", "weight_bytes",
                "kv_dtype", "weight_dtype"):
        assert ts[key] == js[key], key
    want = 1 if kw.get("kv_dtype") else 4
    snap = get_registry().snapshot()
    label = ts["engine_label"]
    for fam, val in (("serving_kv_dtype_bytes", want),
                     ("serving_weight_bytes", ts["weight_bytes"])):
        row = next(r for r in snap[fam]["series"]
                   if r["labels"].get("engine") == label)
        assert row["value"] == val, fam
    mesh = _serving_varz(snap)["mesh"][label]
    assert mesh["kv_dtype_bytes"] == want
    assert mesh["weight_bytes"] == ts["weight_bytes"]
    j.close()
    t.close()


def test_quantized_config_validation(world):
    """Unknown dtype strings raise ValueError at construction (no fp32
    fallback), SlotKVCache too; the kv_dtype x speculate_k gate keys on
    QUANTIZED_KV_KERNELS' verify entry."""
    with pytest.raises(ValueError, match="weight_dtype"):
        ServingConfig(weight_dtype="int4")
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingConfig(kv_dtype="fp8")
    with pytest.raises(ValueError, match="kv_dtype"):
        SlotKVCache(world["tcfg"], 2, 16, kv_dtype="int4")
    kv = SlotKVCache(world["tcfg"], 2, 16, kv_dtype="int8")
    assert kv.kv.dtype == torch.int8 and kv.kv_dtype == "int8"
    assert kv.kv_scales.shape == kv.kv.shape[:-1]
    assert isinstance(kv.arena, tuple) and kv.arena[0] is kv.kv
    covered = tgd.QUANTIZED_KV_KERNELS
    try:
        tgd.QUANTIZED_KV_KERNELS = tuple(
            k for k in covered if k != "gpt_decode_verify_pages")
        with pytest.raises(ValueError, match="verify"):
            make_engine(world, speculate_k=2, kv_dtype="int8")
        make_engine(world, kv_dtype="int8").close()
    finally:
        tgd.QUANTIZED_KV_KERNELS = covered


# -- create_engine(dtype=torch.bfloat16) -------------------------------------

def test_create_engine_bf16_matches_jax(world, tmp_path):
    """create_engine(dtype=torch.bfloat16) over a saved model: bf16
    weights and a bf16 arena, weight_bytes and pool_bytes JAX's
    create_engine(dtype=jnp.bfloat16)'s, greedy streams JAX's (or parted
    at a near tie of JAX's bf16 scores), seeded streams the same at
    decode_chunk 8 with overlap and 4 without."""
    import jax.numpy as jnp
    cfg = world["cfg"]
    scope = pt.Scope()
    with pt.scope_guard(scope):
        for name, arr in world["arrays"].items():
            scope.set_var(name, arr)
        with pt.unique_name_guard():
            main, _, fetches = gpt_lm_program(cfg, 8, is_test=True)
        pt.io.save_inference_model(str(tmp_path), ["tokens"],
                                   [fetches["logits"]], pt.Executor(),
                                   main_program=main)
    sc = _kw({})
    jeng = _opened(pt.inference.create_engine(str(tmp_path), cfg,
                                              JServingConfig(**sc),
                                              dtype=jnp.bfloat16))
    conf = ptt.inference.Config(str(tmp_path))
    conf.disable_gpu()

    def port(**kw):
        return _opened(ptt.inference.create_engine(
            conf, world["tcfg"], ServingConfig(**_kw(kw)),
            dtype=torch.bfloat16))

    eng = port()
    assert eng.scheduler.params["wte"].dtype == torch.bfloat16
    assert eng.kv.kv.dtype == torch.bfloat16
    js, ts = jeng.stats(), eng.stats()
    for key in ("pool_bytes", "weight_bytes", "kv_dtype", "weight_dtype"):
        assert ts[key] == js[key], key
    greedy = MIX[::2]
    jouts = jeng.generate(greedy, 8)
    outs = eng.generate(greedy, 8)
    jp16 = gd.collect_gpt_params(_Scope(world["arrays"]), cfg,
                                 dtype=jnp.bfloat16)
    for i, (p, a, b) in enumerate(zip(greedy, jouts, outs)):
        a, b = np.asarray(a), np.asarray(b)
        diff = np.nonzero(a != b)[0]
        if diff.size:
            n = int(diff[0])
            s = np.sort(np.asarray(gd.gpt_forward_logits(
                jp16, cfg, a[None, :n]))[0, -1])[::-1]
            assert s[0] - s[1] < TIE, f"bf16 greedy[{i}] token {n}"
    seeded = [dict(temperature=0.8, seed=9 + i) for i in range(len(MIX))]
    a = [eng.submit(p, 8, **kw) for p, kw in zip(MIX, seeded)]
    eng.run_until_drained()
    e4 = port(decode_chunk=4, overlap=False)
    b = [e4.submit(p, 8, **kw) for p, kw in zip(MIX, seeded)]
    e4.run_until_drained()
    assert [r.tokens for r in a] == [r.tokens for r in b]
    jeng.close()
    eng.close()
    e4.close()


class _Scope:
    """A read-only scope over a name -> array dict (collect_gpt_params
    reads through find_var)."""

    def __init__(self, arrays):
        self._arrays = arrays

    def find_var(self, name):
        return self._arrays.get(name)


# -- bench_serving --quantize -------------------------------------------------

def test_bench_serving_quantize_rows():
    """paddle_tpu_torch.tools.bench_serving --quantize on the tiny model:
    one row a mode; weight_bytes and pool_bytes equal a JAX engine's at
    the bench's geometry (int8 weights >= 2x smaller, the int8 arena with
    its scale plane >= 2.5x); the streams' determinism asserted inside
    the workload; the teacher-forced budget (agreement >= 0.99, logit
    delta <= 0.05) met. No tokens/s ratio is asserted: CPU timing is no
    measurement."""
    from paddle_tpu_torch.tools import bench_serving
    rows = bench_serving.run_quantize("tiny", requests=6, max_new=16,
                                      device="cpu")
    by_mode = {r["metric"].split("_quant_")[1]: r["extra"] for r in rows}
    assert list(by_mode) == ["fp32", "int8w", "int8w_int8kv"]
    gpt_kwargs = bench_serving.MODELS["tiny"][0]
    buckets, prompt_len, _, slots = bench_serving.QUANTIZE["tiny"]
    cfg = GPTConfig(**gpt_kwargs)
    with pt.unique_name_guard():
        _, startup, _ = gpt_lm_program(cfg, 8, is_test=True)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor().run(startup)
        jp = gd.collect_gpt_params(scope, cfg)
    for mode, e in by_mode.items():
        assert e["completed"] == 6 and e["streams_deterministic"] is True
        assert e["greedy_token_agreement"] >= 0.99
        assert e["max_logit_delta"] <= 0.05
        assert 0 < e["stream_agreement"] <= 1.0
        assert e["compiled_executables"] <= len(buckets) + 2
        j = JServingEngine(jp, cfg, JServingConfig(
            num_slots=slots, prefill_buckets=buckets,
            max_len=prompt_len + 16, **MODES.get(mode, {})))
        js = j.stats()
        j.close()
        for key in ("weight_bytes", "pool_bytes", "weight_dtype",
                    "kv_dtype"):
            assert e[key] == js[key], (mode, key)
    assert by_mode["fp32"]["greedy_token_agreement"] == 1.0
    assert by_mode["fp32"]["max_logit_delta"] == 0.0
    assert by_mode["int8w"]["weight_bytes"] * 2 \
        <= by_mode["fp32"]["weight_bytes"]
    assert by_mode["int8w_int8kv"]["pool_bytes"] * 2.5 \
        <= by_mode["fp32"]["pool_bytes"]
