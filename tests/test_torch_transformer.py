"""The NMT Transformer slice of the PyTorch port against the JAX package,
on the CPU, at a tiny size (hidden 32, 4 heads, ffn 64, 2 layers, source
vocab 50 and target vocab 60, source 12 and target 10 tokens).

  * the ops the NMT Transformer and the encoder block append that no
    earlier slice had (elementwise_sub, the reduce family, tril_triu,
    transpose2, squeeze2, unsqueeze2, add_position_encoding,
    sequence_mask, gather_tree) as one-op programs through both executors
    over the attrs the builders use, op_test style: outputs within 1e-5
    and input gradients within 5e-3 (`tests/op_test.py`'s tolerances),
    the same declared shapes and dtypes, the same grad-op descs;
  * `transformer_nmt` with Adam: both DSLs build the same program and
    startup; from the JAX startup values (carried by name) one step's
    logits (1e-5) and loss (1e-5 relative) and every gradient (1e-6 +
    1e-4 relative), then 3 Adam steps: losses 1e-5 relative, parameters
    1e-5, moments as `tests/test_torch_gpt_train.py` holds them;
  * `encoder_block_program` (weights from `encoder_block_weights`): the
    same checks;
  * `as_torch_function` against `as_jax_function` on the NMT program;
  * the decoders: `greedy_decode` and `beam_search_decode` against the
    JAX package's, each driving its own package's step over the same
    weights (sequences equal, scores within 1e-5); greedy equals beam
    size 1; `beam_search_decode_on_device` against the host loop (with
    and without a cached state, with a given reorder_state), the tie rule
    on a constructed tie against JAX's `lax.top_k` variant, and its
    refusals;
  * `make_dygraph_encoder` raises naming ROADMAP A.12, and the port's new
    modules import neither jax nor paddle_tpu (subprocess).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.layers import decode as jdec
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.layers import decode as tdec
from paddle_tpu_torch.models import transformer as ttr
from test_torch_book import build_both, carry_startup
from test_torch_gpt_inference import _program_dict
from test_torch_ops import _both, _int32, _run_grad
from torch_port_common import one_torch_thread  # noqa: F401


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5          # op_test's output tolerance
GRAD_TOL = 5e-3     # op_test's gradient tolerance
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
LR = 1e-3
SV, TV, SL, TL = 50, 60, 12, 10
BOS, EOS = 1, 0
_R = np.random.RandomState(31)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


_lens = np.array([3, 0, 5, 2], np.int64)
_ids = _R.randint(0, 7, (4, 2, 3)).astype(np.int64)
_parents = _R.randint(0, 3, (4, 2, 3)).astype(np.int64)

# (case id, op type, inputs, output slots, attrs, gradient wrt slots or
# None for forward only)
_CASES = [
    ("sub_same", "elementwise_sub", {"X": _f(2, 3, 4), "Y": _f(2, 3, 4)},
     ["Out"], {"axis": -1}, ["X", "Y"]),
    ("sub_axis1", "elementwise_sub", {"X": _f(2, 3, 4), "Y": _f(3)},
     ["Out"], {"axis": 1}, ["X", "Y"]),
    ("sub_scalar_from", "elementwise_sub", {"X": _f(1), "Y": _f(3, 5)},
     ["Out"], {"axis": -1}, ["X", "Y"]),
    ("reduce_sum_all", "reduce_sum", {"X": _f(2, 3, 4)}, ["Out"],
     {"reduce_all": True, "keep_dim": False}, ["X"]),
    ("reduce_sum_dims_keep", "reduce_sum", {"X": _f(2, 3, 4)}, ["Out"],
     {"dim": [1, 2], "keep_dim": True}, ["X"]),
    ("reduce_sum_last", "reduce_sum", {"X": _f(2, 3, 4)}, ["Out"],
     {"dim": [-1], "keep_dim": False}, ["X"]),
    ("reduce_mean_dim1", "reduce_mean", {"X": _f(2, 5, 4)}, ["Out"],
     {"dim": [1], "keep_dim": False}, ["X"]),
    ("reduce_mean_vector", "reduce_mean", {"X": _f(6)}, ["Out"],
     {"dim": [0], "keep_dim": False}, ["X"]),
    ("reduce_max_keep", "reduce_max", {"X": _f(3, 5)}, ["Out"],
     {"dim": [-1], "keep_dim": True}, ["X"]),
    ("reduce_min_all", "reduce_min", {"X": _f(3, 5)}, ["Out"],
     {"reduce_all": True}, ["X"]),
    ("reduce_prod", "reduce_prod", {"X": _f(3, 4) + 2}, ["Out"],
     {"dim": [0, 1], "keep_dim": False}, ["X"]),
    ("reduce_all", "reduce_all", {"X": _R.rand(3, 4) > 0.2}, ["Out"],
     {"dim": [1], "keep_dim": False}, None),
    ("reduce_any", "reduce_any", {"X": _R.rand(3, 4) > 0.8}, ["Out"],
     {"reduce_all": True}, None),
    ("tril", "tril_triu", {"X": _f(5, 5)}, ["Out"],
     {"diagonal": 0, "lower": True}, ["X"]),
    ("triu_diag1", "tril_triu", {"X": _f(2, 4, 6)}, ["Out"],
     {"diagonal": 1, "lower": False}, ["X"]),
    ("tril_diag_neg", "tril_triu", {"X": _f(4, 6)}, ["Out"],
     {"diagonal": -1, "lower": True}, ["X"]),
    ("transpose2_heads", "transpose2", {"X": _f(2, 3, 4, 5)},
     ["Out", "XShape"], {"axis": [0, 2, 1, 3]}, ["X"]),
    ("transpose2_2d", "transpose2", {"X": _f(3, 4)}, ["Out", "XShape"],
     {"axis": [1, 0]}, ["X"]),
    ("squeeze2_axis", "squeeze2", {"X": _f(4, 1, 3)}, ["Out", "XShape"],
     {"axes": [1]}, ["X"]),
    ("squeeze2_keeps_wide", "squeeze2", {"X": _f(4, 3, 1)},
     ["Out", "XShape"], {"axes": [1, -1]}, ["X"]),
    ("squeeze2_all", "squeeze2", {"X": _f(1, 4, 1)}, ["Out", "XShape"],
     {"axes": []}, ["X"]),
    ("unsqueeze2_bias", "unsqueeze2", {"X": _f(3, 5)}, ["Out", "XShape"],
     {"axes": [1, 2]}, ["X"]),
    ("unsqueeze2_front", "unsqueeze2", {"X": _f(4, 4)}, ["Out", "XShape"],
     {"axes": [0, 1]}, ["X"]),
    ("position_encoding", "add_position_encoding", {"X": _f(2, 16, 32)},
     ["Out"], {"alpha": 1.0, "beta": 1.0}, ["X"]),
    ("position_encoding_odd_d", "add_position_encoding",
     {"X": _f(2, 7, 9)}, ["Out"], {"alpha": 0.5, "beta": 2.0}, ["X"]),
    ("sequence_mask_f32", "sequence_mask", {"X": _lens}, ["Y"],
     {"maxlen": 6, "out_dtype": "float32"}, None),
    ("sequence_mask_int64", "sequence_mask", {"X": _lens}, ["Y"],
     {"maxlen": 4, "out_dtype": "int64"}, None),
    ("gather_tree", "gather_tree", {"Ids": _ids, "Parents": _parents},
     ["Out"], {}, None),
]


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_nmt_op_matches_jax(case):
    _, op_type, inputs, outputs, attrs, wrt = case
    (jvals, jdecl), (tvals, tdecl) = _both(op_type, inputs, outputs, attrs)
    for n in jvals:
        assert tdecl[n][0] == jdecl[n][0], n
        assert _int32(tdecl[n][1]) == _int32(jdecl[n][1]), n
        assert tvals[n].shape == jvals[n].shape, n
        np.testing.assert_allclose(tvals[n], jvals[n], atol=TOL, rtol=TOL,
                                   err_msg=n)
    if wrt is None:
        return
    jg, jdesc = _run_grad(pt, pt.Executor(), op_type, inputs, outputs,
                          attrs, outputs[0], wrt)
    tg, tdesc = _run_grad(ptt, ptt.Executor(ptt.CPUPlace()), op_type,
                          inputs, outputs, attrs, outputs[0], wrt)
    assert tdesc == jdesc
    assert len(tg) == len(jg) > 0
    for t, j in zip(tg, jg):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, atol=GRAD_TOL, rtol=GRAD_TOL)


def test_gather_tree_backtraces_parents():
    """A hand-checked backtrace: t=2, one batch row, beam 2."""
    ids = torch.tensor([[[4, 5]], [[6, 7]]])
    parents = torch.tensor([[[0, 0]], [[1, 0]]])
    from paddle_tpu_torch.framework.registry import LowerContext, get_op_def
    out = get_op_def("gather_tree").lower(
        LowerContext(), {"Ids": [ids], "Parents": [parents]}, {})["Out"][0]
    # beam 0 ends in 6 from parent beam 1 (5); beam 1 in 7 from beam 0 (4)
    assert out[:, 0].tolist() == [[5, 4], [6, 7]]


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _nmt_build(pkg):
    mod = jtr if pkg is pt else ttr
    return mod.transformer_nmt(SV, TV, SL, TL, hidden=32, heads=4,
                               ffn_dim=64, n_layers=2)


def _adam(pkg):
    return pkg.optimizer.Adam(LR)


@pytest.fixture(scope="module")
def nmt():
    return build_both(_nmt_build, _adam)


def _nmt_feed(seed, batch=3):
    """Padded batch: every row's lengths at least 1, some below the max."""
    r = np.random.RandomState(seed)
    feed = {"src": r.randint(2, SV, (batch, SL)),
            "src_lens": r.randint(SL // 2, SL + 1, (batch, 1)),
            "tgt_in": r.randint(2, TV, (batch, TL)),
            "tgt_out": r.randint(2, TV, (batch, TL)),
            "tgt_lens": r.randint(TL // 2, TL + 1, (batch, 1))}
    feed["src_lens"][0, 0] = SL
    return {k: v.astype(np.int64) for k, v in feed.items()}


def _adam_trajectories(jprog, tprog, feeds, fetch_first):
    """len(feeds) steps in each package from the JAX startup values; step
    1's `fetch_first` and gradients are kept. Returns (jax, port),
    each (losses, step-1 fetches, final persistables), and the
    parameters."""
    (jmain, jstartup, jspec), (tmain, _, tspec) = jprog, tprog
    jscope, tscope, persist = carry_startup(jmain, jstartup)
    params = [p.name for p in jmain.global_block.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    runs = []
    for exe, main, spec, scope in (
            (pt.Executor(), jmain, jspec, jscope),
            (ptt.Executor(ptt.CPUPlace()), tmain, tspec, tscope)):
        losses, first = [], None
        # one fetch list for every step: JAX compiles the step once
        extra = [spec[k] for k in fetch_first] + grads
        for i, feed in enumerate(feeds):
            res = exe.run(main, feed=feed,
                          fetch_list=[spec["loss"]] + extra, scope=scope)
            losses.append(float(np.ravel(res[0])[0]))
            if i == 0:
                first = dict(zip(list(fetch_first) + grads,
                                 (np.asarray(v) for v in res[1:])))
        state = {n: np.asarray(scope.find_var(n)) if scope is jscope
                 else scope.get_numpy(n) for n in persist}
        runs.append((losses, first, state))
    return runs[0], runs[1], params


def _check_trajectories(jax_run, port_run, params, fetch_first):
    np.testing.assert_allclose(port_run[0], jax_run[0], rtol=LOSS_RTOL)
    for n, want in jax_run[1].items():
        tol = (TOL, TOL) if n in fetch_first else (GRAD_ATOL, GRAD_RTOL)
        np.testing.assert_allclose(port_run[1][n], want, atol=tol[0],
                                   rtol=tol[1], err_msg=n)
    for n, want in jax_run[2].items():
        got = port_run[2][n]
        if n in params:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                       err_msg=n)
        elif "moment2" in n:
            np.testing.assert_allclose(got, want, atol=1e-12, rtol=1e-3,
                                       err_msg=n)
        else:   # moment1, beta pows, learning rate
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-3,
                                       err_msg=n)


def test_nmt_program_matches_jax(nmt):
    (jmain, jstartup, _), (tmain, tstartup, _) = nmt
    types = [op.type for op in tmain.global_block.ops]
    assert types == [op.type for op in jmain.global_block.ops]
    assert {"add_position_encoding", "sequence_mask", "tril_triu",
            "squeeze2", "unsqueeze2", "elementwise_sub", "reduce_sum",
            "einsum", "adam", "add_position_encoding_grad"} <= set(types)
    assert _program_dict(tmain) == _program_dict(jmain)
    assert _program_dict(tstartup) == _program_dict(jstartup)


def test_nmt_adam_steps_match_jax(nmt):
    """Step 1's logits, loss and every gradient, then 3 Adam steps on
    padded batches."""
    feeds = [_nmt_feed(10 + i) for i in range(3)]
    jax_run, port_run, params = _adam_trajectories(*nmt, feeds, ["logits"])
    assert len(jax_run[1]) == len(params) + 1
    _check_trajectories(jax_run, port_run, params, ["logits"])


def test_encoder_block_adam_steps_match_jax():
    """encoder_block_program from one encoder_block_weights dict (pre-LN
    stack, transpose2/matmul attention, reduce_mean pool)."""
    w = jtr.encoder_block_weights(32, 4, 64, 2, 40)
    progs = []
    for pkg, mod in ((pt, jtr), (ptt, ttr)):
        with pkg.unique_name_guard():
            main, startup, loss = mod.encoder_block_program(
                w, 32, 4, 64, 2, 12, 40)
            with pkg.program_guard(main, startup):
                pkg.optimizer.Adam(LR).minimize(loss)
        progs.append((main, startup, {"loss": loss}))
    assert _program_dict(progs[1][0]) == _program_dict(progs[0][0])
    assert {"transpose2", "reduce_mean", "matmul"} <= {
        op.type for op in progs[1][0].global_block.ops}
    r = np.random.RandomState(7)
    feeds = [{"tokens": r.randint(0, 40, (4, 12)).astype(np.int64),
              "label": r.randint(0, 40, (4, 1)).astype(np.int64)}
             for _ in range(3)]
    jax_run, port_run, params = _adam_trajectories(*progs, feeds, [])
    _check_trajectories(jax_run, port_run, params, [])


def test_make_dygraph_encoder_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="ROADMAP A.12"):
        ttr.make_dygraph_encoder({}, 32, 4, 64, 1, 40)


# ---------------------------------------------------------------------------
# as_torch_function
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nmt_fns(nmt):
    """Both packages' inference functions over the same startup values:
    (jax fn, jax params, port fn, port params)."""
    (jmain, jstartup, jspec), (tmain, _, tspec) = nmt
    jscope, tscope, persist = carry_startup(jmain, jstartup)
    jparams = {n: np.asarray(jscope.find_var(n)) for n in persist}
    tparams = {n: tscope.find_var(n) for n in persist}
    jinfer = pt.as_jax_function(jmain, [jspec["logits"]], is_test=True)
    jfn = jax.jit(lambda p, f: jinfer(p, f)[0])
    tfn = ptt.as_torch_function(tmain, [tspec["logits"]], is_test=True)
    return jfn, jparams, tfn, tparams


def test_as_torch_function_matches_as_jax_function(nmt, nmt_fns):
    jfn, jparams, tfn, tparams = nmt_fns
    feed = _nmt_feed(40)
    j = np.asarray(jfn(jparams, feed))
    t, = tfn(tparams, {k: torch.from_numpy(v) for k, v in feed.items()})
    assert t.device.type == "cpu" and t.shape == (3, TL, TV)
    np.testing.assert_allclose(t.numpy(), j, atol=TOL, rtol=TOL)
    # numpy feeds become tensors on the inputs' device
    t2, = tfn(tparams, feed)
    torch.testing.assert_close(t2, t, rtol=0, atol=0)
    # is_test=False keeps the train program's ops; the logits are the same
    # (no dropout in the model)
    (_, _, _), (tmain, _, tspec) = nmt
    train_fn = ptt.as_torch_function(tmain, [tspec["logits"], tspec["loss"]],
                                     is_test=False)
    t3, loss = train_fn(tparams, feed)
    torch.testing.assert_close(t3, t, rtol=0, atol=0)
    assert loss.shape == (1,) and torch.isfinite(loss).all()


def test_as_torch_function_device(nmt, nmt_fns, monkeypatch):
    """With no tensor among the inputs the function runs on the card, or
    on the device it was made for; it never falls back to the CPU."""
    _, _, tfn, tparams = nmt_fns
    (_, _, _), (tmain, _, tspec) = nmt
    nparams = {k: v.numpy() for k, v in tparams.items()}
    feed = _nmt_feed(42)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfn(nparams, feed)
    cfn = ptt.as_torch_function(tmain, [tspec["logits"]], device="cpu")
    t, = cfn(nparams, feed)
    ref, = tfn(tparams, feed)
    assert t.device.type == "cpu"
    torch.testing.assert_close(t, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="made for meta"):
        ptt.as_torch_function(tmain, [tspec["logits"]],
                              device="meta")(tparams, feed)


def test_as_torch_function_refusals(nmt_fns):
    _, _, tfn, tparams = nmt_fns
    meta = {k: v.to("meta") for k, v in list(tparams.items())[:1]}
    with pytest.raises(ValueError, match="several devices"):
        tfn(dict(tparams, **meta), _nmt_feed(41))
    for pkg, fn in ((pt, pt.as_jax_function), (ptt, ptt.as_torch_function)):
        main = pkg.Program()
        blk = main.global_block
        blk.create_var(name="x", shape=(2,), dtype="float32")
        blk.append_op("save", {"X": ["x"]}, {}, {"file_path": "/dev/null"},
                      infer_shape=False)
        with pytest.raises(ValueError, match="host-boundary"):
            fn(main, ["x"])


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------

def _host_step(fn, params, src, lens, rep, to_input):
    """A host-loop step over the NMT logits: the prefix padded to TL (the
    decoder is causal, so the padding never reaches position t - 1)."""
    s_rep = np.repeat(src, rep, 0)
    l_rep = np.repeat(lens, rep, 0)

    def step(prefix):
        t = prefix.shape[1]
        tin = np.concatenate(
            [prefix, np.zeros((prefix.shape[0], TL - t), np.int64)], 1)
        feed = {"src": s_rep, "src_lens": l_rep, "tgt_in": tin,
                "tgt_out": np.zeros_like(tin),
                "tgt_lens": np.full((prefix.shape[0], 1), TL, np.int64)}
        out = fn(params, {k: to_input(v) for k, v in feed.items()})
        return (out[0] if isinstance(out, list) else out)[:, t - 1, :]
    return step


def _device_step(tfn, tparams, src, lens, rep):
    s_rep = torch.from_numpy(np.repeat(src, rep, 0))
    l_rep = torch.from_numpy(np.repeat(lens, rep, 0))

    def step(tokens, t):
        tin = tokens[:, :TL]
        return tfn(tparams, {"src": s_rep, "src_lens": l_rep, "tgt_in": tin,
                             "tgt_out": torch.zeros_like(tin),
                             "tgt_lens": torch.full((tin.shape[0], 1), TL)}
                   )[0][:, t]
    return step


def test_decoders_match_jax(nmt_fns):
    """Each package's host loops over its own step on the same weights;
    the port's on-device beam search against its host loop; greedy ==
    beam size 1."""
    jfn, jparams, tfn, tparams = nmt_fns
    b, k = 2, 3
    feed = _nmt_feed(50, batch=b)
    src, lens = feed["src"], feed["src_lens"]
    ident = lambda v: v   # noqa: E731
    jg = jdec.greedy_decode(_host_step(jfn, jparams, src, lens, 1, ident),
                            b, BOS, EOS, TL)
    tg = tdec.greedy_decode(
        _host_step(tfn, tparams, src, lens, 1, torch.from_numpy),
        b, BOS, EOS, TL)
    np.testing.assert_array_equal(tg, jg)
    js, jsc = jdec.beam_search_decode(
        _host_step(jfn, jparams, src, lens, k, ident), b, k, BOS, EOS, TL)
    tstep = _host_step(tfn, tparams, src, lens, k, torch.from_numpy)
    ts, tsc = tdec.beam_search_decode(tstep, b, k, BOS, EOS, TL)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5)
    ds, dsc = tdec.beam_search_decode_on_device(
        _device_step(tfn, tparams, src, lens, k), b, k, BOS, EOS, TL,
        device="cpu")
    np.testing.assert_array_equal(ds, ts)
    np.testing.assert_allclose(dsc, tsc, rtol=1e-5)
    b1, _ = tdec.beam_search_decode(
        _host_step(tfn, tparams, src, lens, 1, torch.from_numpy),
        b, 1, BOS, EOS, TL)
    np.testing.assert_array_equal(b1[:, 0], tg)


# a Markov chain of next-token logits (the JAX package's own on-device
# test) and a state-carrying version of it: the state is a rolling hash
# of the prefix, and the table row is picked by the hash
_V, _B, _K, _L = 7, 2, 3, 5
_TABLE = np.random.RandomState(0).randn(_V, _V).astype(np.float32) * 2


def _host_markov(tokens):
    return _TABLE[np.asarray(tokens)[:, -1]]


def _dev_markov(tokens, t):
    return torch.from_numpy(_TABLE)[tokens[:, t]]


def _hash_logits(h):
    return torch.from_numpy(_TABLE)[h % _V] + 0.1 * (h // _V % 3)[:, None]


def _uncached(tokens, t):
    h = torch.zeros(tokens.shape[0], dtype=torch.int64)
    for i in range(t + 1):
        h = (h * 3 + tokens[:, i]) % 101
    return _hash_logits(h)


def _cached(tokens, t, h):
    h = (h * 3 + tokens[:, t]) % 101
    return _hash_logits(h), h


@pytest.mark.parametrize("lp", [0.0, 0.6])
def test_on_device_beam_matches_host_loop(lp):
    hs, hsc = tdec.beam_search_decode(_host_markov, _B, _K, BOS, EOS, _L,
                                      length_penalty=lp)
    ds, dsc = tdec.beam_search_decode_on_device(
        _dev_markov, _B, _K, BOS, EOS, _L, length_penalty=lp, device="cpu")
    np.testing.assert_array_equal(ds, hs)
    np.testing.assert_allclose(dsc, hsc, rtol=1e-5)
    js, jsc = jdec.beam_search_decode(_host_markov, _B, _K, BOS, EOS, _L,
                                      length_penalty=lp)
    np.testing.assert_array_equal(hs, js)
    np.testing.assert_allclose(hsc, jsc, rtol=1e-5)


def test_on_device_beam_cached_state_matches_uncached():
    """init_state with the default reorder (leading dim b*k), and a state
    whose batch axis is the second one with its own reorder_state."""
    seqs_u, scores_u = tdec.beam_search_decode_on_device(
        _uncached, _B, _K, BOS, EOS, _L, device="cpu")
    h0 = torch.zeros(_B * _K, dtype=torch.int64)
    seqs_c, scores_c = tdec.beam_search_decode_on_device(
        _cached, _B, _K, BOS, EOS, _L, init_state=h0)
    np.testing.assert_array_equal(seqs_c, seqs_u)
    np.testing.assert_array_equal(scores_c, scores_u)

    def cached_t(tokens, t, state):
        logits, h = _cached(tokens, t, state["h"][0])
        return logits, {"h": h[None].repeat(2, 1)}

    def reorder(state, parent):
        flat = (parent + torch.arange(_B)[:, None] * _K).reshape(-1)
        return {"h": state["h"][:, flat]}
    seqs_t, scores_t = tdec.beam_search_decode_on_device(
        cached_t, _B, _K, BOS, EOS, _L,
        init_state={"h": h0[None].repeat(2, 1)}, reorder_state=reorder)
    np.testing.assert_array_equal(seqs_t, seqs_u)
    np.testing.assert_array_equal(scores_t, scores_u)


def test_beam_tie_goes_to_the_lower_index_as_in_jax():
    """All-equal logits: every candidate ties, and the lower flat index
    wins in both packages' on-device variants (JAX: lax.top_k) and the
    host loop."""
    v, b, k, L = 6, 2, 3, 3

    def tdev(tokens, t):
        return torch.zeros(tokens.shape[0], v)

    def jdev(tokens, t):
        return jnp.zeros((tokens.shape[0], v))
    ds, dsc = tdec.beam_search_decode_on_device(tdev, b, k, BOS, 5, L,
                                                device="cpu")
    js, jsc = jdec.beam_search_decode_on_device(jdev, b, k, BOS, 5, L)
    hs, hsc = tdec.beam_search_decode(lambda p: np.zeros((p.shape[0], v)),
                                      b, k, BOS, 5, L)
    np.testing.assert_array_equal(ds, js)
    np.testing.assert_array_equal(hs, js)
    np.testing.assert_allclose(dsc, jsc, rtol=1e-6)
    # every step's top-3 are the first beam's tokens 0, 1, 2 (the lowest
    # flat indices), so all three beams descend from [0, 0]
    assert ds[0].tolist() == [[0, 0, 0], [0, 0, 1], [0, 0, 2]]


@pytest.mark.parametrize("seed", [0, 4, 8])
def test_smoke_beam_replay_is_exact_for_both_decoders(seed):
    """chip_smoke.py's numpy replay of the beam selection gives each
    decoder's sequences and scores bitwise from the log-probs its steps saw
    (logits rounded to 0.1 for many exact ties; a raised eos logit for
    finished beams and, at seeds 4 and 8, a host loop that stops early)."""
    from chip_smoke import _beam_parting, _beam_replay, _host_log_softmax
    b, k, L, v, eos = 3, 4, 7, 11, 0
    r = np.random.RandomState(seed)
    tab = np.round(r.randn(L, b * k, v), 1).astype(np.float32)
    tab[:, :, eos] += r.rand() * 2
    dev, host = [], []

    def dstep(tokens, t):
        dev.append(torch.from_numpy(tab[t]))
        return dev[-1]

    def hstep(prefix):
        host.append(tab[prefix.shape[1] - 1])
        return host[-1]
    ds, dsc = tdec.beam_search_decode_on_device(dstep, b, k, BOS, eos, L,
                                                device="cpu")
    hs, hsc = tdec.beam_search_decode(hstep, b, k, BOS, eos, L)
    lp = torch.stack([torch.log_softmax(x, -1) for x in dev]).numpy()
    rs, rsc, dsteps = _beam_replay(lp, b, k, eos, L)
    np.testing.assert_array_equal(rs, ds)
    np.testing.assert_array_equal(rsc, dsc)
    hrs, hrsc, hsteps = _beam_replay([_host_log_softmax(x) for x in host],
                                     b, k, eos, L)
    np.testing.assert_array_equal(hrs, hs)
    np.testing.assert_array_equal(hrsc, hsc)
    assert _beam_parting(hsteps, dsteps, b) == []
    # a swapped pair is found at its step, with both loops' gaps
    dsteps[2][1][1, [0, 1]] = dsteps[2][1][1, [1, 0]]
    part, = _beam_parting(hsteps, dsteps, b)
    assert (part["row"], part["step"], part["rank"]) == (1, 2, 0)
    assert part["host_gap"] >= 0 and part["device_gap"] <= 0


def test_on_device_beam_refusals(monkeypatch):
    bad = torch.zeros(2, _B * _K)
    with pytest.raises(ValueError, match="reorder"):
        tdec.beam_search_decode_on_device(
            lambda tok, t, s: (torch.zeros(_B * _K, _V), s), _B, _K,
            BOS, EOS, _L, init_state=bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.beam_search_decode_on_device(_dev_markov, _B, _K, BOS, EOS, _L)


def test_new_modules_import_neither_jax_nor_paddle_tpu():
    """The NMT, book and image modules and the decoders, built and run in a
    fresh interpreter, pull in no jax and no paddle_tpu module."""
    code = (
        "import sys, numpy as np, torch\n"
        "import paddle_tpu_torch as ptt\n"
        "from paddle_tpu_torch import nets\n"
        "from paddle_tpu_torch.layers import decode\n"
        "from paddle_tpu_torch.models import (transformer, book, lenet,\n"
        "                                     vgg)\n"
        "main, startup = ptt.Program(), ptt.Program()\n"
        "with ptt.program_guard(main, startup):\n"
        "    s = transformer.transformer_nmt(20, 20, 4, 4, hidden=8,\n"
        "                                    heads=2, ffn_dim=8,\n"
        "                                    n_layers=1)\n"
        "    book.fit_a_line(3)\n"
        "    lenet.lenet(ptt.layers.data('img', [1, 28, 28]))\n"
        "    nets.glu(ptt.layers.data('g', [4]))\n"
        "exe = ptt.Executor(ptt.CPUPlace()); sc = ptt.Scope()\n"
        "exe.run(startup, scope=sc)\n"
        "fn = ptt.as_torch_function(main, [s['logits']])\n"
        "p = {n: sc.find_var(n) for n in sc.var_names()\n"
        "     if isinstance(sc.find_var(n), torch.Tensor)}\n"
        "src = torch.full((2, 4), 3)\n"
        "def step(tok, t):\n"
        "    return fn(p, {'src': src, 'src_lens': torch.full((2, 1), 4),\n"
        "                  'tgt_in': tok[:, :4], 'tgt_out': tok[:, :4],\n"
        "                  'tgt_lens': torch.full((2, 1), 4)})[0][:, t]\n"
        "seqs, _ = decode.beam_search_decode_on_device(\n"
        "    step, 2, 1, 1, 0, 4, device='cpu')\n"
        "assert seqs.shape == (2, 1, 4)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'paddle_tpu'\n"
        "             or m.startswith('paddle_tpu.'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
