"""KV-cache decoding of the PyTorch port (`paddle_tpu_torch.models.
gpt_decode`) against the JAX package's, on the CPU, on the tiny GPT of
tests/test_serving.py. The JAX startup values are carried into the
port's scope (`io.set_params_from_numpy`) and `collect_gpt_params` runs
on both sides.

  * the dense path (full forward, prefill, padded prefill, decode step)
    and greedy gpt_generate;
  * the paged path: prefill of a suffix over a resident prefix, chunked
    prefill, the decode step with frozen slots, the decode chunk loop
    greedy and seeded — logits and every real arena row (scratch block 0
    excluded: frozen and pad writes land there in either order);
  * the index rules JAX gets from XLA (a gather clamps): pad rows whose
    page index and position run past the page row and the position table,
    and a decode slot whose position reached the end of its row;
  * the sampler: threefry2x32 bitwise, sample_gumbel to 1e-6 (relative,
    and absolute near 0).

Tolerance 1e-5 (f32 end to end, summation order differs).
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import gpt_decode as gd
from paddle_tpu.models.gpt import GPTConfig, gpt_lm_program
from paddle_tpu.serving.scheduler import ContinuousBatchingScheduler
from paddle_tpu_torch.models import gpt_decode as tgd
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from torch_port_common import one_torch_thread  # noqa: F401


TOL = 1e-5


def _cfg(mod):
    return mod(vocab_size=97, hidden=32, layers=2, heads=4, max_pos=64,
               dropout=0.0, attn_impl="xla")


@pytest.fixture(scope="module")
def both():
    """(jax cfg, jax params, port cfg, port params) from one startup."""
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
    return cfg, jp, tcfg, tgd.collect_gpt_params(tscope, tcfg)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=tol,
                               atol=tol)


def _tokens(rng, shape):
    return rng.randint(0, 97, shape).astype(np.int32)


# -- dense path ---------------------------------------------------------------

def test_forward_prefill_padded_and_step_match_jax(both):
    cfg, jp, tcfg, tp = both
    rng = np.random.RandomState(0)
    toks = _tokens(rng, (2, 9))
    _close(gd.gpt_forward_logits(jp, cfg, toks),
           tgd.gpt_forward_logits(tp, tcfg, toks))
    jl, jc = gd.gpt_prefill(jp, cfg, toks, 16)
    tl, tc = tgd.gpt_prefill(tp, tcfg, toks, 16)
    _close(jl, tl)
    _close(jc, tc)
    padded = np.zeros((2, 12), np.int32)
    padded[:, :9] = toks
    padded[1, 7:] = 0
    real = np.asarray([9, 7], np.int32)
    jl, jc = gd.gpt_prefill_padded(jp, cfg, padded, real, 16)
    tl, tc = tgd.gpt_prefill_padded(tp, tcfg, padded, real, 16)
    _close(jl, tl)
    _close(jc, tc)
    nxt = np.asarray([5, 11], np.int32)
    jl, jc = gd.gpt_decode_step(jp, cfg, nxt, jc, 12)
    tl, tc = tgd.gpt_decode_step(tp, tcfg, nxt, tc, 12)
    _close(jl, tl)
    _close(jc, tc)


def test_greedy_generate_token_identical(both):
    cfg, jp, tcfg, tp = both
    rng = np.random.RandomState(1)
    for n in (1, 4, 9):
        prompt = _tokens(rng, (2, n))
        np.testing.assert_array_equal(
            tgd.gpt_generate(tp, tcfg, prompt, 7),
            gd.gpt_generate(jp, cfg, prompt, 7))


# -- paged path ----------------------------------------------------------------

def _arena(rng, cfg, num_blocks, bs):
    """A random arena: rows no write touched still hold values the
    attention of an unmasked position would read."""
    shape = (cfg.layers, 2, num_blocks, cfg.heads, bs,
             cfg.hidden // cfg.heads)
    return rng.standard_normal(shape).astype(np.float32)


def _real_rows_close(ja, ta):
    _close(np.asarray(ja)[:, :, 1:], ta[:, :, 1:])


@pytest.mark.parametrize("fn,start,real,bucket", [
    ("gpt_prefill_pages", 0, 5, 8),          # cold prompt, pad rows
    ("gpt_prefill_pages", 8, 3, 4),          # suffix over 2 hit blocks
    ("gpt_prefill_chunk_pages", 6, 5, 8),    # chunk at any position
    ("gpt_prefill_chunk_pages", 13, 3, 8),   # pad rows past the page row
])
def test_prefill_pages_match_jax(both, fn, start, real, bucket):
    cfg, jp, tcfg, tp = both
    rng = np.random.RandomState(2)
    arena = _arena(rng, cfg, 9, 4)
    pages = np.asarray([3, 7, 1, 5], np.int32)           # 16 positions
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :real] = _tokens(rng, (real,))
    jl, ja = getattr(gd, fn)(jp, cfg, jnp.asarray(toks), np.int32(start),
                             np.int32(real), jnp.asarray(arena),
                             jnp.asarray(pages))
    tarena = torch.from_numpy(arena.copy())
    tl, ta = getattr(tgd, fn)(tp, tcfg, toks, start, real, tarena, pages)
    assert ta is tarena                                  # written in place
    _close(jl, tl)
    _real_rows_close(ja, ta)


def test_prefill_pads_past_position_table_stay_in_scratch(both):
    """A page row as long as max_pos and a suffix bucket running past it:
    pad rows' page index and position both run past their tables (XLA
    clamps the gathers, the port clamps explicitly) and their writes go
    to scratch; the real rows and logits match."""
    cfg, jp, tcfg, tp = both
    rng = np.random.RandomState(3)
    arena = _arena(rng, cfg, 17, 4)
    pages = np.arange(1, 17, dtype=np.int32)[::-1].copy()  # 64 positions
    toks = np.zeros((1, 8), np.int32)
    toks[0, :2] = _tokens(rng, (2,))
    jl, ja = gd.gpt_prefill_pages(jp, cfg, jnp.asarray(toks), np.int32(60),
                                  np.int32(2), jnp.asarray(arena),
                                  jnp.asarray(pages))
    tl, ta = tgd.gpt_prefill_pages(tp, tcfg, toks, 60, 2,
                                   torch.from_numpy(arena.copy()), pages)
    _close(jl, tl)
    _real_rows_close(ja, ta)


def _decode_inputs(rng, cfg, n_pages, s_dim=3):
    num_blocks = 1 + s_dim * n_pages
    arena = _arena(rng, cfg, num_blocks, 4)
    pt_ = (1 + rng.permutation(s_dim * n_pages)).reshape(
        s_dim, n_pages).astype(np.int32)
    return arena, pt_


@pytest.mark.parametrize("ts,done", [
    ([5, 9, 15], None),
    ([5, 9, 15], [False, True, False]),      # frozen slot -> scratch
    ([16, 3, 0], [False, False, True]),      # ts at the row's end
])
def test_decode_step_pages_match_jax(both, ts, done):
    cfg, jp, tcfg, tp = both
    rng = np.random.RandomState(4)
    arena, pt_ = _decode_inputs(rng, cfg, 4)
    toks = _tokens(rng, (3,))
    ts = np.asarray(ts, np.int32)
    jd = None if done is None else jnp.asarray(done)
    td = None if done is None else torch.tensor(done)
    jl, ja = gd.gpt_decode_step_pages(jp, cfg, jnp.asarray(toks),
                                      jnp.asarray(arena), jnp.asarray(pt_),
                                      jnp.asarray(ts), jd)
    tl, ta = tgd.gpt_decode_step_pages(tp, tcfg, toks,
                                       torch.from_numpy(arena.copy()), pt_,
                                       ts, td)
    _close(jl, tl)
    _real_rows_close(ja, ta)


def test_decode_step_at_max_pos_clamps_like_jax(both):
    """A live slot at position max_pos (64) with a 64-position page row:
    both the page index and the position-table row run past their
    tables."""
    cfg, jp, tcfg, tp = both
    rng = np.random.RandomState(5)
    arena, pt_ = _decode_inputs(rng, cfg, 16, s_dim=2)
    toks = _tokens(rng, (2,))
    ts = np.asarray([64, 30], np.int32)
    jl, ja = gd.gpt_decode_step_pages(jp, cfg, jnp.asarray(toks),
                                      jnp.asarray(arena), jnp.asarray(pt_),
                                      jnp.asarray(ts))
    tl, ta = tgd.gpt_decode_step_pages(
        tp, tcfg, toks, torch.from_numpy(arena.copy()), pt_, ts)
    _close(jl, tl)
    _real_rows_close(ja, ta)


def _jax_sampler(top_k):
    """The JAX engine's per-slot sampler, vmapped by the chunk kernel."""
    return functools.partial(ContinuousBatchingScheduler._sample_row,
                             types.SimpleNamespace(top_k=top_k))


@pytest.mark.parametrize("top_k,temps", [
    (None, (0.0, 0.0, 0.0)),                 # greedy (no sampler)
    (0, (0.8, 0.0, 1.3)),                    # seeded, full vocab
    (5, (0.8, 0.5, 0.0)),                    # seeded, top-k
])
def test_decode_chunk_pages_match_jax(both, top_k, temps):
    cfg, jp, tcfg, tp = both
    rng = np.random.RandomState(6)
    arena, pt_ = _decode_inputs(rng, cfg, 4)
    toks = _tokens(rng, (3,))
    ts = np.asarray([3, 6, 2], np.int32)
    keys = rng.randint(0, 2 ** 32, (3, 2), dtype=np.uint64) \
        .astype(np.uint32)
    temps = np.asarray(temps, np.float32)
    done = np.asarray([False, False, True])
    remaining = np.asarray([3, 9, 0], np.int32)          # slot 0 freezes
    eos = np.asarray([-1, -1, -1], np.int32)
    jout = gd.gpt_decode_chunk_pages(
        jp, cfg, *map(jnp.asarray, (toks, arena, pt_, ts, keys, temps, done,
                                    remaining, eos)), 5, sample_fn=None if top_k is None else _jax_sampler(top_k))
    tarena = torch.from_numpy(arena.copy())
    tout = tgd.gpt_decode_chunk_pages(
        tp, tcfg, torch.from_numpy(toks).long(), tarena,
        torch.from_numpy(pt_).long(), torch.from_numpy(ts).long(),
        torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(temps),
        torch.from_numpy(done), torch.from_numpy(remaining).long(),
        torch.from_numpy(eos).long(), 5,
        sample_fn=None if top_k is None else tgd.make_sampler(top_k))
    jblock, jtok, ja, jts, jkeys, jdone, jrem = jout
    tblock, ttok, ta, tts, tkeys, tdone, trem = tout
    np.testing.assert_array_equal(tblock.numpy(), np.asarray(jblock))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(trem.numpy(), np.asarray(jrem))
    np.testing.assert_array_equal(tkeys.numpy(),
                                  np.asarray(jkeys).astype(np.int64))
    assert ta is tarena
    _real_rows_close(ja, ta)
    col0 = tblock.numpy()[:, 0]
    assert (col0[3:] == col0[2]).all()                  # frozen repeats


# -- sampler ---------------------------------------------------------------------

def test_threefry2x32_bitwise():
    rng = np.random.RandomState(7)
    keys = rng.randint(0, 2 ** 32, (256, 2), dtype=np.uint64) \
        .astype(np.uint32)
    x0 = rng.randint(0, 2 ** 32, (256,), dtype=np.uint64).astype(np.uint32)
    x1 = rng.randint(0, 2 ** 32, (256,), dtype=np.uint64).astype(np.uint32)
    m = np.uint32(0xFFFFFFFF)
    keys[:4] = [[m, m], [0, 0], [m, 0], [0, m]]
    x0[:6] = [m, 0, m, m - 1, 1, m]                     # wraparound sums
    x1[:6] = [m, m, 0, m, m, 1]
    jy = gd.threefry2x32(jnp.asarray(keys), jnp.asarray(x0),
                         jnp.asarray(x1))
    ty = tgd.threefry2x32(torch.from_numpy(keys.astype(np.int64)),
                          torch.from_numpy(x0.astype(np.int64)),
                          torch.from_numpy(x1.astype(np.int64)))
    for j, t in zip(jy, ty):
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(j).astype(np.int64))
    for seed in (0, 23, 2 ** 31 - 1, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            tgd.sample_key(seed).numpy(),
            np.asarray(gd.sample_key(np.uint32(seed))).astype(np.int64))
        np.testing.assert_array_equal(
            tgd.sample_split(tgd.sample_key(seed)).numpy(),
            np.asarray(gd.sample_split(gd.sample_key(np.uint32(seed))))
            .astype(np.int64))


def test_sample_gumbel_matches_jax():
    """The bits are equal; the two logs are XLA's and torch's, an ulp
    apart at most, so 1e-6 relative — and 1e-6 absolute, since g crosses
    0 at u = 1/e, where a relative error has no meaning."""
    rng = np.random.RandomState(8)
    keys = rng.randint(0, 2 ** 32, (16, 2), dtype=np.uint64) \
        .astype(np.uint32)
    for key in keys:
        j = np.asarray(gd.sample_gumbel(jnp.asarray(key), 97))
        t = tgd.sample_gumbel(torch.from_numpy(key.astype(np.int64)),
                              97).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
