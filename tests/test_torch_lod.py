"""LoD of the PyTorch port against the JAX package, on the CPU.

  * `lod_tensor.py` (a numpy copy): the conversions of
    tests/test_nested_lod.py with the reference's golden values, and the
    same results as the JAX module's;
  * the nested sequence-op programs of tests/test_nested_lod.py (pooling
    at the inner level with an empty segment, softmax, reverse, expand at
    both levels, three levels deep) and its hierarchical doc classifier
    (5 Adam steps from the same weights) through both executors;
  * the 17 LoD-array ops: rank table, max length, tensor arrays in and
    out, split/merge by mask, reorder and shrink by rank, beam search,
    state gather and decode, ctc_align and chunk_eval in its four schemes:
    outputs within 1e-5 of JAX's, and the gradients of the differentiable
    ones within 5e-3 (tests/op_test.py's tolerances);
  * `reader/bucketing.py` (a numpy copy): tests/test_bucketing.py's policy
    cases, and its compile-count cases against the port executor's
    compile cache (a ragged stream compiles at most one step per bucket;
    the LRU keeps its bound and its hot entry).
"""

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import lod_tensor as jlt
from paddle_tpu_torch import lod_tensor as tlt
from paddle_tpu_torch.reader import bucketing
from test_torch_control_flow import check_both
from torch_port_common import one_torch_thread  # noqa: F401


TOL = 1e-5
GRAD_TOL = 5e-3


# ---------------------------------------------------------------------------
# lod_tensor.py
# ---------------------------------------------------------------------------

def test_lod_conversions_match_reference_and_jax():
    length = [[2, 1], [3, 2, 4]]
    offset = tlt.convert_to_offset_based(length)
    assert [o.tolist() for o in offset] == [[0, 2, 3], [0, 3, 5, 9]]
    assert tlt.convert_to_length_based(offset) == length
    lod = [[0, 3, 4, 8], [0, 9, 10, 11, 13, 17, 19, 22, 24]]
    assert tlt.to_abs_offsets(lod)[0].tolist() == [0, 11, 13, 24]
    lens3 = [[2, 1], [2, 1, 2], [3, 1, 2, 2, 1]]
    lod3 = tlt.convert_to_offset_based(lens3)
    assert tlt.to_abs_offsets(lod3)[0].tolist() == [0, 6, 9]
    padded, plens = tlt.lod_to_padded(np.arange(9), lod3, level=0)
    assert plens.tolist() == [6, 3]
    np.testing.assert_array_equal(padded[0], np.arange(6))
    for a, b in zip(tlt.to_abs_offsets(lod3), jlt.to_abs_offsets(lod3)):
        np.testing.assert_array_equal(a, b)


def test_lod_tensor_create_and_validate():
    vals, lod = ptt.create_lod_tensor(np.arange(6, dtype=np.int64),
                                      [[2, 1], [3, 1, 2]], None)
    assert [l.tolist() for l in lod] == [[0, 2, 3], [0, 3, 4, 6]]
    vals, off = ptt.create_lod_tensor([[1, 2, 3], [4, 5]], [[3, 2]], None)
    assert isinstance(off, np.ndarray) and off.tolist() == [0, 3, 5]
    for bad in ((np.arange(6), [[2, 2], [3, 1, 2]]),
                (np.arange(5), [[2, 1], [3, 1, 2]])):
        with pytest.raises(ValueError):
            ptt.create_lod_tensor(*bad, None)


def test_nested_padded_roundtrip_matches_jax():
    rng = np.random.RandomState(3)
    lod = tlt.convert_to_offset_based([[2, 1, 3], [4, 2, 5, 1, 3, 2]])
    vals = rng.rand(17, 4).astype(np.float32)
    got = tlt.lod_to_nested_padded(vals, lod)
    want = jlt.lod_to_nested_padded(vals, lod)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (3, 3, 5, 4)
    v2, lod2 = tlt.nested_padded_to_lod(*got)
    np.testing.assert_array_equal(v2, vals)
    assert [l.tolist() for l in lod2] == [l.tolist() for l in lod]
    padded, lens = tlt.lod_to_padded(np.arange(6, dtype=np.int64),
                                     [[0, 2, 3], [0, 3, 4, 6]], level=0)
    assert lens.tolist() == [4, 2]
    vals2, off2 = tlt.padded_to_lod(padded, lens)
    np.testing.assert_array_equal(vals2, np.arange(6))


# ---------------------------------------------------------------------------
# nested sequence ops (tests/test_nested_lod.py)
# ---------------------------------------------------------------------------

_NX = np.random.RandomState(0).rand(2, 3, 4, 5).astype(np.float32)
_INNER = np.array([[4, 2, 0], [1, 3, 2]], np.int64)


def _inner(fn, x_shape=(3, 4, 5)):
    def build(pkg):
        x = pkg.layers.data("x", list(x_shape))
        il = pkg.layers.data("il", [3], dtype="int64")
        return [fn(pkg.layers, x, il)], 1
    return build


_NESTED = [
    ("inner_pool_average", _inner(
        lambda L, x, il: L.sequence_pool(x, "average", lengths=il)),
     {"x": _NX, "il": _INNER}),
    ("inner_pool_max_empty_segment", _inner(
        lambda L, x, il: L.sequence_pool(x, "max", lengths=il)),
     {"x": _NX, "il": _INNER}),
    ("inner_pool_last", _inner(
        lambda L, x, il: L.sequence_pool(x, "last", lengths=il)),
     {"x": _NX, "il": _INNER}),
    ("inner_softmax", _inner(
        lambda L, x, il: L.sequence_softmax(x, lengths=il), (3, 4)),
     {"x": _NX[..., 0], "il": _INNER}),
    ("inner_reverse", _inner(
        lambda L, x, il: L.sequence_reverse(x, lengths=il)),
     {"x": _NX, "il": _INNER}),
]


@pytest.mark.parametrize("build,feed", [c[1:] for c in _NESTED],
                         ids=[c[0] for c in _NESTED])
def test_nested_sequence_op_matches_jax(build, feed):
    (_, t), = check_both(build, [feed])
    assert np.all(np.isfinite(t[0]))


def test_inner_pool_max_of_empty_segment_is_zero():
    (_, t), = check_both(_NESTED[1][1], [_NESTED[1][2]])
    np.testing.assert_array_equal(t[0][0, 2], np.zeros(5))
    np.testing.assert_allclose(t[0][0, 0], _NX[0, 0, :4].max(0), rtol=1e-6)


def test_expand_both_levels_and_three_level_pool_match_jax():
    def build(pkg):
        L = pkg.layers
        doc = L.data("doc", [5])
        sent = L.data("sent", [3, 5])
        words = L.data("w", [3, 4, 5])
        x3 = L.data("x3", [2, 3, 4, 5])
        ln3 = L.data("ln3", [2, 3], dtype="int64")
        return [L.sequence_expand(doc, sent, ref_level=0),
                L.sequence_expand(sent, words, ref_level=1),
                L.sequence_pool(x3, "sum", lengths=ln3)], 3
    rng = np.random.RandomState(1)
    feed = {"doc": rng.rand(2, 5).astype(np.float32),
            "sent": rng.rand(2, 3, 5).astype(np.float32),
            "w": rng.rand(2, 3, 4, 5).astype(np.float32),
            "x3": rng.rand(2, 2, 3, 4, 5).astype(np.float32),
            "ln3": rng.randint(0, 5, (2, 2, 3)).astype(np.int64)}
    (_, t), = check_both(build, [feed])
    np.testing.assert_allclose(
        t[1], np.broadcast_to(feed["sent"][:, :, None], (2, 3, 4, 5)))


def test_expand_wrong_ref_level_raises():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        doc = ptt.layers.data("doc", [5])
        sent = ptt.layers.data("sent", [3, 5])
        with pytest.raises(Exception, match="ref_level"):
            ptt.layers.sequence_expand(doc, sent, ref_level=1)


def test_hierarchical_doc_classifier_steps_match_jax():
    """Words pooled to sentences, sentences to documents, a classifier on
    top: 5 Adam steps from the same weights, losses within 1e-5."""
    S1, S2, V, D, C, B = 4, 6, 50, 16, 3, 16

    def build(pkg):
        L = pkg.layers
        w = L.data("w", [S1, S2], dtype="int64")
        il = L.data("il", [S1], dtype="int64")
        ol = L.data("ol", [], dtype="int64")
        label = L.data("y", [1], dtype="int64")
        emb = L.embedding(w, size=[V, D])
        sent = L.sequence_pool(emb, "average", lengths=il)
        doc = L.sequence_pool(sent, "sum", lengths=ol)
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(doc, C), label))
        pkg.optimizer.Adam(5e-2).minimize(loss)
        return [loss], 1

    rng = np.random.RandomState(0)
    lens_outer = rng.randint(1, S1 + 1, B)
    lens_inner = np.zeros((B, S1), np.int64)
    words = np.zeros((B, S1, S2), np.int64)
    for i in range(B):
        for j in range(lens_outer[i]):
            lens_inner[i, j] = rng.randint(1, S2 + 1)
            words[i, j, :lens_inner[i, j]] = rng.randint(0, V,
                                                         lens_inner[i, j])
    feed = {"w": words, "il": lens_inner, "ol": lens_outer.astype(np.int64),
            "y": (words[:, 0, 0] % C).astype(np.int64)[:, None]}
    res = check_both(build, [feed] * 5)
    losses = [float(t[0][0]) for _, t in res]
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# the 17 LoD-array ops
# ---------------------------------------------------------------------------

_SHAPES = {"back": (3, 5, 2), "concat": (3, 10), "reordered": (3, 5, 2),
           "reset": (3, 5, 2), "shrunk": (3, 2), "t_rows": (3, 2),
           "f_rows": (3, 2), "merged": (3, 2), "helped": (3, 2),
           "gathered": (6, 4)}


def _op(blk, op_type, ins, outs, attrs=None, dtypes=None):
    """Append op_type without build-time inference (tuples — rank
    tables, arrays — have no static shape); a float tensor output a later
    layer reads gets its shape from _SHAPES."""
    for slot, names in outs.items():
        for n in names:
            blk.create_var(name=n, shape=_SHAPES.get(n),
                           dtype=(dtypes or {}).get(n, "float32"))
    blk.append_op(op_type, ins, outs, attrs or {}, infer_shape=False)


def _lod_array_program(pkg):
    blk = pkg.default_main_program().global_block
    L = pkg.layers
    x = L.data("x", [3, 5, 2], append_batch_size=False)
    x.stop_gradient = False
    lens = L.data("lens", [3], dtype="int64", append_batch_size=False)
    mask = L.data("mask", [3, 1], dtype="bool", append_batch_size=False)
    mem = L.data("mem", [3, 2], append_batch_size=False)
    mem.stop_gradient = False
    step = L.fill_constant([1], "int64", 2)
    _op(blk, "lod_rank_table", {"X": ["x"], "XLength": ["lens"]},
        {"Out": ["table"]})
    _op(blk, "max_sequence_len", {"RankTable": ["table"]},
        {"Out": ["maxlen"]}, dtypes={"maxlen": "int64"})
    _op(blk, "lod_tensor_to_array", {"X": ["x"], "RankTable": ["table"]},
        {"Out": ["arr"]})
    _op(blk, "array_to_lod_tensor", {"X": ["arr"], "RankTable": ["table"]},
        {"Out": ["back"]})
    _op(blk, "lod_array_length", {"X": ["arr"]}, {"Out": ["arr_len"]},
        dtypes={"arr_len": "int64"})
    _op(blk, "tensor_array_to_tensor", {"X": ["arr"]},
        {"Out": ["concat"], "OutIndex": ["concat_idx"]}, {"axis": 1},
        dtypes={"concat_idx": "int32"})
    _op(blk, "reorder_lod_tensor_by_rank",
        {"X": ["x"], "RankTable": ["table"]}, {"Out": ["reordered"]})
    _op(blk, "shrink_rnn_memory",
        {"X": ["mem"], "RankTable": ["table"], "I": [step.name]},
        {"Out": ["shrunk"]})
    _op(blk, "lod_reset", {"X": ["x"], "Y": ["lens"]}, {"Out": ["reset"]})
    _op(blk, "split_lod_tensor", {"X": ["mem"], "Mask": ["mask"]},
        {"OutTrue": ["t_rows"], "OutFalse": ["f_rows"]})
    _op(blk, "merge_lod_tensor",
        {"InTrue": ["t_rows"], "InFalse": ["f_rows"], "Mask": ["mask"]},
        {"Out": ["merged"]})
    _op(blk, "rnn_memory_helper", {"X": ["mem"]}, {"Out": ["helped"]})
    outs = ["maxlen", "back", "arr_len", "concat", "concat_idx",
            "reordered", "shrunk", "reset", "t_rows", "f_rows", "merged",
            "helped"]
    floats = ["back", "concat", "reordered", "shrunk", "reset", "t_rows",
              "f_rows", "merged", "helped"]
    w = L.data("wts", [len(floats)], append_batch_size=False)
    loss = None
    for k, n in enumerate(floats):
        term = L.reduce_sum(L.scale(L.square(blk.var(n)), scale=k + 1.0))
        loss = term if loss is None else L.elementwise_add(loss, term)
    loss = L.elementwise_add(loss, L.reduce_sum(w))
    gx, gm = pkg.gradients([loss], [x, mem])
    return [blk.var(n) for n in outs] + [gx, gm], len(outs)


def test_lod_array_ops_match_jax():
    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(3, 5, 2).astype(np.float32),
            "lens": np.array([2, 5, 3], np.int64),
            "mask": np.array([[True], [False], [True]]),
            "mem": rng.randn(3, 2).astype(np.float32),
            "wts": np.ones(9, np.float32)}
    (_, t), = check_both(_lod_array_program, [feed])
    assert int(t[0][0]) == 5 and int(t[2][0]) == 5
    np.testing.assert_array_equal(t[1], feed["x"])      # round trip
    np.testing.assert_array_equal(t[5], feed["x"][[1, 2, 0]])
    np.testing.assert_array_equal(t[10], feed["mem"])  # merge(split)


def _beam_program(pkg):
    blk = pkg.default_main_program().global_block
    L = pkg.layers
    pre_ids = L.data("pre_ids", [2, 3], dtype="int64",
                     append_batch_size=False)
    pre_scores = L.data("pre_scores", [2, 3], append_batch_size=False)
    scores = L.data("scores", [2, 3, 7], append_batch_size=False)
    state = L.data("state", [6, 4], append_batch_size=False)
    state.stop_gradient = False
    ids = L.data("ids", [4, 2, 3], dtype="int64", append_batch_size=False)
    parents = L.data("parents", [4, 2, 3], dtype="int64",
                     append_batch_size=False)
    step_scores = L.data("step_scores", [4, 2, 3], append_batch_size=False)
    _op(blk, "beam_search", {"pre_ids": ["pre_ids"],
                             "pre_scores": ["pre_scores"],
                             "scores": ["scores"]},
        {"selected_ids": ["sel_ids"], "selected_scores": ["sel_scores"],
         "parent_idx": ["parent"]}, {"end_id": 0, "beam_size": 3},
        dtypes={"sel_ids": "int64", "parent": "int32"})
    _op(blk, "beam_state_gather", {"State": ["state"], "Parent": ["parent"]},
        {"Out": ["gathered"]})
    _op(blk, "beam_search_decode",
        {"Ids": ["ids"], "ParentIdx": ["parents"], "Scores": ["step_scores"]},
        {"SentenceIds": ["sent_ids"], "SentenceScores": ["sent_scores"]},
        dtypes={"sent_ids": "int64"})
    gs, = pkg.gradients([L.reduce_sum(L.square(blk.var("gathered")))],
                        [state])
    return [blk.var(n) for n in ("sel_ids", "sel_scores", "parent",
                                 "gathered", "sent_ids", "sent_scores")] \
        + [gs], 6


def test_beam_ops_match_jax():
    rng = np.random.RandomState(5)
    sc = np.log(rng.dirichlet(np.ones(7), (2, 3))).astype(np.float32)
    sc[0, 1, 4] = sc[0, 1, 5]            # a tie: the lower index first
    feed = {"pre_ids": np.array([[3, 0, 2], [1, 4, 0]], np.int64),
            "pre_scores": rng.randn(2, 3).astype(np.float32),
            "scores": sc, "state": rng.randn(6, 4).astype(np.float32),
            "ids": rng.randint(0, 9, (4, 2, 3)).astype(np.int64),
            "parents": rng.randint(0, 3, (4, 2, 3)).astype(np.int64),
            "step_scores": rng.randn(4, 2, 3).astype(np.float32)}
    check_both(_beam_program, [feed])


def _decode_eval_program(scheme, num_types):
    def build(pkg):
        blk = pkg.default_main_program().global_block
        L = pkg.layers
        L.data("seq", [3, 8], dtype="int64", append_batch_size=False)
        L.data("seq_len", [3], dtype="int64", append_batch_size=False)
        L.data("inf", [3, 8], dtype="int64", append_batch_size=False)
        L.data("lab", [3, 8], dtype="int64", append_batch_size=False)
        _op(blk, "ctc_align", {"Input": ["seq"], "InputLength": ["seq_len"]},
            {"Output": ["aligned"], "OutputLength": ["aligned_len"]},
            {"blank": 0, "merge_repeated": True, "padding_value": -1},
            dtypes={"aligned": "int64", "aligned_len": "int32"})
        names = ["Precision", "Recall", "F1-Score", "NumInferChunks",
                 "NumLabelChunks", "NumCorrectChunks"]
        _op(blk, "chunk_eval", {"Inference": ["inf"], "Label": ["lab"],
                                "SeqLength": ["seq_len"]},
            {n: [f"ce_{n}"] for n in names},
            {"num_chunk_types": num_types, "chunk_scheme": scheme},
            dtypes={f"ce_{n}": "int64" for n in names[3:]})
        return [blk.var(n) for n in ["aligned", "aligned_len"]
                + [f"ce_{n}" for n in names]], 8
    return build


@pytest.mark.parametrize("scheme,num_types", [
    ("IOB", 3), ("IOE", 3), ("IOBES", 2), ("plain", 4)])
def test_ctc_align_and_chunk_eval_match_jax(scheme, num_types):
    rng = np.random.RandomState(6)
    n_tags = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    hi = num_types * n_tags + 1
    lab = rng.randint(0, hi, (3, 8)).astype(np.int64)
    inf = lab.copy()
    flip = rng.rand(3, 8) < 0.3
    inf[flip] = rng.randint(0, hi, flip.sum())
    feed = {"seq": rng.randint(0, 4, (3, 8)).astype(np.int64),
            "seq_len": np.array([8, 5, 3], np.int64),
            "inf": inf, "lab": lab}
    (_, t), = check_both(_decode_eval_program(scheme, num_types), [feed])
    assert int(t[5][0]) > 0                # some label chunks were counted


# ---------------------------------------------------------------------------
# reader/bucketing.py
# ---------------------------------------------------------------------------

def test_bucket_policy():
    assert bucketing.pow2_boundaries(8, 64) == [8, 16, 32, 64]
    assert bucketing.pow2_boundaries(8, 100) == [8, 16, 32, 64, 100]
    bounds = [8, 16, 32]
    assert [bucketing.bucket_for(n, bounds) for n in (1, 8, 9, 99)] == \
        [8, 8, 16, 32]
    p = bucketing.pad_to_bucket(np.ones((2, 5, 3)), [8, 16], axis=1)
    assert p.shape == (2, 8, 3) and not p[:, 5:].any()
    t = bucketing.pad_to_bucket(np.ones((2, 20, 3)), [8, 16], axis=1)
    assert t.shape == (2, 16, 3)


def test_bucketed_reader_tuple_and_dict():
    def r():
        yield (np.ones((4, 5)), np.array([5, 3, 5, 1]))
        yield (np.ones((4, 11)), np.array([11, 2, 7, 11]))

    batches = list(bucketing.bucketed(r, slots=[0], boundaries=[8, 16],
                                      lengths_slot=1)())
    assert batches[0][0].shape == (4, 8) and batches[1][0].shape == (4, 16)

    def rd():
        yield {"x": np.ones((2, 30, 3)), "len": np.array([30, 12])}

    out = next(iter(bucketing.bucketed(rd, slots=["x"], boundaries=[8, 16],
                                       lengths_slot="len")()))
    assert out["x"].shape == (2, 16, 3) and out["len"].tolist() == [16, 12]


def _seq_program():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [-1, -1, 8])  # [b, ragged t, 8]
        ln = ptt.layers.data("ln", [], dtype="int64")
        out = ptt.layers.fc(ptt.layers.sequence_pool(x, "average",
                                                     lengths=ln), 4)
    return main, startup, out


def test_ragged_stream_compiles_at_most_one_step_per_bucket():
    main, startup, out = _seq_program()
    bounds = [8, 16, 32, 64]
    rng = np.random.RandomState(0)

    def stream():
        for _ in range(60):
            t = int(rng.randint(1, 65))
            yield {"x": rng.rand(6, t, 8).astype(np.float32),
                   "ln": rng.randint(1, t + 1, size=6).astype(np.int64)}

    exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    exe.run(startup, scope=scope)
    start = exe.compile_count
    for feed in bucketing.bucketed(stream, slots=["x"], boundaries=bounds,
                                   lengths_slot="ln")():
        exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    assert exe.compile_count - start <= len(bounds)


def test_cache_bound_and_lru_hot_entry():
    main, startup, out = _seq_program()

    def run(exe, scope, t):
        exe.run(main, feed={"x": np.ones((2, t, 8), np.float32),
                            "ln": np.full(2, t, np.int64)},
                fetch_list=[out], scope=scope)

    exe, scope = ptt.Executor(ptt.CPUPlace(), cache_capacity=3), ptt.Scope()
    exe.run(startup, scope=scope)
    for t in range(1, 11):
        run(exe, scope, t)
    assert len(exe._cache) <= 3
    exe, scope = ptt.Executor(ptt.CPUPlace(), cache_capacity=2), ptt.Scope()
    exe.run(startup, scope=scope)
    run(exe, scope, 4)
    run(exe, scope, 5)
    c0 = exe.compile_count
    run(exe, scope, 4)             # hit, keeps 4 hot
    assert exe.compile_count == c0
    run(exe, scope, 6)             # evicts 5, not 4
    run(exe, scope, 4)             # still cached
    assert exe.compile_count == c0 + 1
