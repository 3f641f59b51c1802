"""The PyTorch port's speculative-decoding and slot-slab functions
(`paddle_tpu_torch.models.gpt_decode`) against the JAX package's, on the
CPU, on the tiny GPT of tests/test_torch_serving.py (vocab 97, hidden 32,
2 layers, max_pos 64), the same weights on both sides:

  * `_ngram_hash` bit-equal at the edge tokens (0, vocab - 1, -1, equal
    pairs, 2^31 - 1) and sizes 1, 7 and 512;
  * `spec_ngram_seed` bit-equal (the whole table, trash column included)
    with real_len < B, with B < 3, and with a prompt that repeats a
    context before different tokens;
  * `gpt_decode_verify_slots` at D = 1 is `gpt_decode_step_slots` row for
    row; both, and `gpt_decode_verify_pages` at D = 4 with done slots and
    past-the-row writes, match JAX's logits (1e-5) and K/V (the arena's
    non-scratch blocks), also with drafts past n_positions;
  * both chunk loops in spec mode, greedy and seeded (chunk 6, k 3):
    block, counts, ts, keys, done, remaining and the drafter table
    bitwise JAX's, and the committed stream the non-spec loop's;
  * a pass that commits one context three times keeps JAX's last write.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import gpt_decode as gd
from paddle_tpu.models.gpt import GPTConfig, gpt_lm_program
from paddle_tpu_torch.models import gpt_decode as tgd
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from torch_port_common import one_torch_thread  # noqa: F401


TOL = 1e-5
V = 97


def _cfg(mod):
    return mod(vocab_size=V, hidden=32, layers=2, heads=4, max_pos=64,
               dropout=0.0, attn_impl="xla")


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
            "tp": tgd.collect_gpt_params(tscope, tcfg)}


def _t(a):
    return torch.as_tensor(np.asarray(a)).long()


def _jsample(key, logits, temp):
    """The JAX engine's per-row sampler at top_k 0 (scheduler.
    _sample_row): threefry Gumbel-max, greedy at temp 0."""
    import jax.numpy as jnp
    key_next = gd.sample_split(key)
    greedy = jnp.argmax(logits, -1).astype(jnp.int32)
    scaled = logits / jnp.maximum(temp, 1e-6)
    drawn = jnp.argmax(scaled + gd.sample_gumbel(key, logits.shape[-1]))
    return jnp.where(temp > 0.0, drawn.astype(jnp.int32), greedy), key_next


# -- the drafter --------------------------------------------------------------

@pytest.mark.parametrize("size", [1, 7, 512])
def test_ngram_hash_bit_equal(size):
    import jax.numpy as jnp
    rng = np.random.RandomState(size)
    edge = [0, V - 1, 50256, 2 ** 31 - 1, -1]
    a = np.array(edge + edge + list(rng.randint(0, 2 ** 31 - 1, 64)),
                 np.int64)
    b = np.array(edge + edge[::-1] + list(rng.randint(0, 2 ** 31 - 1, 64)),
                 np.int64)
    want = np.asarray(gd._ngram_hash(jnp.asarray(a, jnp.int32),
                                     jnp.asarray(b, jnp.int32), size))
    got = tgd._ngram_hash(_t(a), _t(b), size).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < size


@pytest.mark.parametrize("case", ["short_real_len", "b_lt_3",
                                  "repeated_context"])
@pytest.mark.parametrize("size", [7, 64])
def test_spec_ngram_seed_bit_equal(case, size):
    import jax.numpy as jnp
    rng = np.random.RandomState(3)
    if case == "short_real_len":
        tokens, real_len = rng.randint(0, V, 16), 9
    elif case == "b_lt_3":
        tokens, real_len = rng.randint(0, V, 2), 2
    else:
        # (5, 6) precedes 7, then 8, then 9: the last write wins
        tokens, real_len = np.array([5, 6, 7, 5, 6, 8, 1, 5, 6, 9, 0, 0]), 10
    table = rng.randint(-1, V, (3, size + 1))
    want = np.asarray(gd.spec_ngram_seed(
        jnp.asarray(table, jnp.int32), 1, jnp.asarray(tokens, jnp.int32),
        jnp.int32(real_len)))
    got = tgd.spec_ngram_seed(_t(table), 1, _t(tokens), real_len)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "repeated_context":
        assert got[1, int(tgd._ngram_hash(_t(5), _t(6), size))] == 9


def test_spec_step_same_context_committed_three_times():
    """A pass whose committed run names one table column three times
    (context (0, 0) before 0, 0, then 5) keeps the last write, as JAX's
    scatter does; a frozen slot's writes all go to the trash column."""
    import jax.numpy as jnp
    k, size, s_dim = 4, 16, 2
    cands = np.array([[0, 0, 0, 0, 5], [3, 1, 4, 1, 5]])
    logits = np.full((s_dim, k + 1, 8), -1.0, np.float32)
    for s in range(s_dim):
        logits[s, np.arange(k + 1), cands[s]] = 1.0
    prev, tok = np.array([2, 7]), np.array([4, 6])
    table = np.full((s_dim, size + 1), -1)
    ts, rem = np.array([3, 3]), np.array([20, 20])
    done = np.array([False, True])
    eos = np.array([-1, -1])

    def jverify(inputs, pool, ts, done):
        return jnp.asarray(logits), pool

    def tverify(inputs, pool, ts, done):
        return torch.as_tensor(logits), pool

    jkeys = jnp.zeros((s_dim, 2), jnp.uint32)
    jc, (jout, jcnt) = gd._spec_step(
        jverify, lambda key, lg, tp: (jnp.argmax(lg).astype(jnp.int32), key),
        jnp.zeros((s_dim,), jnp.float32), jnp.asarray(eos, jnp.int32), k,
        (jnp.asarray(tok, jnp.int32), None, jnp.asarray(ts, jnp.int32),
         jkeys, jnp.asarray(done), jnp.asarray(rem, jnp.int32),
         jnp.asarray(prev, jnp.int32), jnp.asarray(table, jnp.int32)))
    tc, (tout, tcnt) = tgd._spec_step(
        tverify, tgd.greedy_sample, torch.zeros(s_dim), _t(eos), k,
        (_t(tok), None, _t(ts), torch.zeros((s_dim, 2), dtype=torch.long),
         torch.as_tensor(done), _t(rem), _t(prev), _t(table)))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    for i in (0, 2, 4, 5, 6, 7):     # tok, ts, done, rem, prev, table
        np.testing.assert_array_equal(tc[i].numpy(), np.asarray(jc[i]))
    assert tcnt.tolist() == [5, 1]
    assert tc[7][0, int(tgd._ngram_hash(_t(0), _t(0), size))] == 5
    assert tc[7][1, size] == 5       # frozen: the trash column's last


# -- verify passes -----------------------------------------------------------

def _slab_caches(world, lens, seed, max_len):
    """Prefilled slab caches of random prompts on both sides."""
    import jax.numpy as jnp
    rng = np.random.RandomState(seed)
    jc, tc = [], []
    for n in lens:
        p = rng.randint(0, V, (1, n)).astype(np.int32)
        jc.append(gd.gpt_prefill(world["jp"], world["cfg"], p,
                                 max_len=max_len)[1])
        tc.append(tgd.gpt_prefill(world["tp"], world["tcfg"], p,
                                  max_len)[1])
    return jnp.concatenate(jc, axis=2), torch.cat(tc, dim=2)


def test_verify_slots_d1_is_step_slots_and_both_match_jax(world):
    import jax.numpy as jnp
    jcache, tcache = _slab_caches(world, (3, 6, 4), 5, 32)
    tok, ts = np.array([5, 9, 11]), np.array([3, 6, 4])
    jl, jcache2 = gd.gpt_decode_step_slots(
        world["jp"], world["cfg"], jnp.asarray(tok, jnp.int32),
        jcache, jnp.asarray(ts, jnp.int32))
    step_l, step_c = tgd.gpt_decode_step_slots(
        world["tp"], world["tcfg"], _t(tok), tcache.clone(), _t(ts))
    ver_l, ver_c = tgd.gpt_decode_verify_slots(
        world["tp"], world["tcfg"], _t(tok)[:, None], tcache.clone(),
        _t(ts))
    assert torch.equal(ver_l[:, 0], step_l) and torch.equal(ver_c, step_c)
    np.testing.assert_allclose(step_l.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(step_c.numpy(), np.asarray(jcache2),
                               atol=TOL, rtol=TOL)


def test_verify_slots_d4_past_n_positions_matches_jax(world):
    """D = 4 on a slab as long as the position table: slot 1's drafts
    run past max_len = n_positions (wpe clamped, writes dropped)."""
    import jax.numpy as jnp
    jcache, tcache = _slab_caches(world, (5, 8), 6, 64)
    toks = np.random.RandomState(7).randint(0, V, (2, 4))
    ts = np.array([5, 62])
    jl, jc = gd.gpt_decode_verify_slots(
        world["jp"], world["cfg"], jnp.asarray(toks, jnp.int32), jcache,
        jnp.asarray(ts, jnp.int32))
    tl, tc = tgd.gpt_decode_verify_slots(world["tp"], world["tcfg"],
                                         _t(toks), tcache, _t(ts))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL,
                               rtol=TOL)


def test_verify_pages_done_and_past_row_writes_match_jax(world):
    """D = 4 through a page table: slot 0 live mid-row, slot 1 frozen
    (its writes to scratch), slot 2 at the row's end (positions 62..65 of
    a 64-position row: page index past the row -> scratch, wpe past
    n_positions clamped). Logits match JAX's; the non-scratch blocks of
    the arena match JAX's after the pass."""
    import jax.numpy as jnp
    cfg, tcfg = world["cfg"], world["tcfg"]
    rng = np.random.RandomState(8)
    layers, heads, hd, bs, nb = 2, 4, 8, 16, 14
    arena = rng.randn(layers, 2, nb, heads, bs, hd).astype(np.float32)
    pt_ = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]])
    toks = rng.randint(0, V, (3, 4))
    ts = np.array([20, 17, 62])
    done = np.array([False, True, False])
    jl, ja = gd.gpt_decode_verify_pages(
        world["jp"], cfg, jnp.asarray(toks, jnp.int32),
        jnp.asarray(arena), jnp.asarray(pt_, jnp.int32),
        jnp.asarray(ts, jnp.int32), jnp.asarray(done))
    tarena = torch.as_tensor(arena.copy())
    tl, ta = tgd.gpt_decode_verify_pages(
        world["tp"], tcfg, _t(toks), tarena, _t(pt_), _t(ts),
        torch.as_tensor(done))
    assert ta.data_ptr() == tarena.data_ptr()          # written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(ta.numpy()[:, :, 1:], np.asarray(ja)[:, :, 1:],
                               atol=TOL, rtol=TOL)
    # the frozen slot's blocks and the unmapped ones are untouched
    for blk in (4, 5, 10, 11, 12, 13):
        np.testing.assert_array_equal(ta.numpy()[:, :, blk],
                                      arena[:, :, blk])


# -- the chunk loops ----------------------------------------------------------

def _loop_inputs(seed, s_dim, temps):
    import jax.numpy as jnp
    keys = np.stack([np.zeros(s_dim, np.uint32),
                     np.arange(s_dim, dtype=np.uint32) + 17 * seed], 1)
    j = dict(keys=jnp.asarray(keys), temps=jnp.asarray(temps, jnp.float32),
             done=jnp.zeros((s_dim,), bool),
             remaining=jnp.asarray([20, 4, 20][:s_dim], jnp.int32),
             eos_ids=jnp.full((s_dim,), -1, jnp.int32))
    t = dict(keys=torch.as_tensor(keys.astype(np.int64)),
             temps=torch.as_tensor(np.asarray(temps, np.float32)),
             done=torch.zeros(s_dim, dtype=torch.bool),
             remaining=_t([20, 4, 20][:s_dim]),
             eos_ids=torch.full((s_dim,), -1, dtype=torch.long))
    return j, t


def _assert_spec_out_equal(jres, tres, pool_index):
    """(block, counts, tokens, pool, ts, keys, done, remaining, (prev,
    table)): every field but the pool bitwise."""
    for i, (a, b) in enumerate(zip(jres, tres)):
        if i == pool_index:
            continue
        if i == 8:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y.numpy(), np.asarray(x))
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"field {i}")


def _committed(block, counts, s):
    return [int(block[i, j, s]) for i in range(block.shape[0])
            for j in range(int(counts[i, s]))]


@pytest.mark.parametrize("temps", [(0.0, 0.0), (0.8, 0.0)],
                         ids=["greedy", "seeded"])
def test_chunk_slots_spec_bitwise_jax_and_nonspec_stream(world, temps):
    """JAX's kernel pin (tests/test_serving.py, slab path, chunk 6, k 3)
    on the port: the spec loop commits the non-spec loop's stream, and
    every output is JAX's bit for bit, the drafter table included."""
    import jax.numpy as jnp
    jcache, tcache = _slab_caches(world, (3, 6), 40, 32)
    tok0, ts = np.array([5, 9]), np.array([3, 6])
    ji, ti = _loop_inputs(1, 2, temps)
    rem = np.array([20, 20])
    sample_t = tgd.make_sampler(0)
    ref_block, *_ = tgd.gpt_decode_chunk_slots(
        world["tp"], world["tcfg"], _t(tok0), tcache.clone(), _t(ts),
        ti["keys"], ti["temps"], ti["done"], _t(rem), ti["eos_ids"], 6,
        sample_fn=sample_t)
    table = np.full((2, 65), -1)
    jres = gd.gpt_decode_chunk_slots(
        world["jp"], world["cfg"], jnp.asarray(tok0, jnp.int32), jcache,
        jnp.asarray(ts, jnp.int32), ji["keys"], ji["temps"], ji["done"],
        jnp.asarray(rem, jnp.int32), ji["eos_ids"], chunk=6,
        sample_fn=_jsample, speculate_k=3,
        spec_state=(jnp.zeros((2,), jnp.int32),
                    jnp.asarray(table, jnp.int32)))
    tres = tgd.gpt_decode_chunk_slots(
        world["tp"], world["tcfg"], _t(tok0), tcache, _t(ts), ti["keys"],
        ti["temps"], ti["done"], _t(rem), ti["eos_ids"], 6,
        sample_fn=sample_t, speculate_k=3,
        spec_state=(torch.zeros(2, dtype=torch.long), _t(table)))
    _assert_spec_out_equal(jres, tres, 3)
    block, counts = tres[0].numpy(), tres[1].numpy()
    assert block.shape == (6, 4, 2) and counts.shape == (6, 2)
    assert (counts >= 1).all() and (counts <= 4).all()
    for s in range(2):
        assert _committed(block, counts, s)[:6] == \
            ref_block[:, s].tolist()
        assert tres[4][s] == ts[s] + counts[:, s].sum()
        assert tres[7][s] == 20 - counts[:, s].sum()


@pytest.mark.parametrize("temps", [(0.0, 0.0, 0.0), (0.8, 0.0, 0.8)],
                         ids=["greedy", "seeded"])
def test_chunk_pages_spec_bitwise_jax(world, temps):
    """The paged loop in spec mode (chunk 6, k 3) on three slots of a
    prefilled arena, one with a budget ending mid-loop and a repetitive
    prompt (drafts accepted): every output JAX's bit for bit, the
    arena's non-scratch blocks within 1e-5, and the committed streams
    the non-spec loop's."""
    import jax.numpy as jnp
    cfg, tcfg = world["cfg"], world["tcfg"]
    rng = np.random.RandomState(9)
    bs, nb, P = 8, 16, 4
    prompts = [np.tile(rng.randint(0, V, 3), 3)[:8], rng.randint(0, V, 5),
               rng.randint(0, V, 7)]
    pt_ = np.array([[1, 2, 3, 4], [5, 6, 7, 0], [8, 9, 10, 11]])
    jarena = jnp.zeros((2, 2, nb, 4, bs, 8), jnp.float32)
    tarena = torch.zeros((2, 2, nb, 4, bs, 8))
    table = np.full((3, 33), -1)
    jtable, ttable = jnp.asarray(table, jnp.int32), _t(table)
    tok0, ts = [], []
    for s, p in enumerate(prompts):
        padded = np.zeros((1, 8), np.int32)
        padded[0, :p.size] = p
        jl, jarena = gd.gpt_prefill_pages(
            world["jp"], cfg, jnp.asarray(padded), 0, p.size, jarena,
            jnp.asarray(pt_[s], jnp.int32))
        tgd.gpt_prefill_pages(world["tp"], tcfg, padded, 0, p.size,
                              tarena, _t(pt_[s]))
        jtable = gd.spec_ngram_seed(jtable, s, jnp.asarray(padded[0]),
                                    p.size)
        tgd.spec_ngram_seed(ttable, s, _t(padded[0]), p.size)
        tok0.append(int(np.argmax(np.asarray(jl)[0])))
        ts.append(p.size)
    ji, ti = _loop_inputs(2, 3, temps)
    prev = np.array([p[-1] for p in prompts])
    sample_t = tgd.make_sampler(0)
    ref_block, *_ = tgd.gpt_decode_chunk_pages(
        world["tp"], tcfg, _t(tok0), tarena.clone(), _t(pt_), _t(ts),
        ti["keys"], ti["temps"], ti["done"], ti["remaining"],
        ti["eos_ids"], 6, sample_fn=sample_t)
    jres = gd.gpt_decode_chunk_pages(
        world["jp"], cfg, jnp.asarray(tok0, jnp.int32), jarena,
        jnp.asarray(pt_, jnp.int32), jnp.asarray(ts, jnp.int32),
        ji["keys"], ji["temps"], ji["done"], ji["remaining"], ji["eos_ids"],
        chunk=6, sample_fn=_jsample, speculate_k=3,
        spec_state=(jnp.asarray(prev, jnp.int32), jtable))
    tres = tgd.gpt_decode_chunk_pages(
        world["tp"], tcfg, _t(tok0), tarena, _t(pt_), _t(ts), ti["keys"],
        ti["temps"], ti["done"], ti["remaining"], ti["eos_ids"], 6,
        sample_fn=sample_t, speculate_k=3, spec_state=(_t(prev), ttable))
    _assert_spec_out_equal(jres, tres, 3)
    np.testing.assert_allclose(tres[3].numpy()[:, :, 1:],
                               np.asarray(jres[3])[:, :, 1:], atol=TOL,
                               rtol=TOL)
    block, counts = tres[0].numpy(), tres[1].numpy()
    if temps[0] == 0.0:
        assert counts[:, 0].max() >= 2      # the motif's drafts accepted
    assert bool(tres[6][1]) and int(tres[7][1]) == 0  # budget 4 spent
    for s in range(3):
        n = min(6, int(ji["remaining"][s]))
        assert _committed(block, counts, s)[:n] == \
            ref_block[:n, s].tolist()
