"""The book and image models of the PyTorch port against the JAX package,
on the CPU, at a small size.

  * the ops the book models and `nets` append that no earlier slice had
    (concat, split, sigmoid, tanh, square_error_cost) as one-op programs
    through both executors, op_test style: outputs within 1e-5, input
    gradients within 5e-3 (`tests/op_test.py`'s tolerances);
  * LeNet-5 (MNIST-shaped, 1x28x28, 10 classes), fit_a_line, word2vec
    (dense and is_sparse=True), recommender (narrow vocabularies) and the
    five `nets` helpers (simple_img_conv_pool, img_conv_group with
    batch_norm, glu, scaled_dot_product_attention, switch_moe_ffn,
    sequence_conv_pool): both DSLs build the same programs, op
    for op with their slots, attrs and vars, and the same startup; then
    one SGD step from the JAX startup values (carried by name with
    io.set_params_from_numpy): the loss within 1e-5 relative and every
    parameter gradient within 1e-6 + 1e-4 relative (tighter than
    op_test's 5e-3);
  * VGG-16 through `image_classification_program("vgg16")` at 32x32:
    its `clone(for_test=True)` forward (batch_norm on the running
    statistics, dropout off) within 1e-5 of JAX's;
  * the recurrent book models (seq2seq_attention, label_semantic_roles,
    rnn_encoder_decoder) at tests/test_book_models.py's shapes, one SGD
    step each, held the same way.
"""

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import nets as jnets
from paddle_tpu.models import book as jbook
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import nets as tnets
from paddle_tpu_torch.models import book as tbook
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tresnet
from test_torch_gpt_inference import _program_dict
from test_torch_ops import _both, _run_grad
from torch_port_common import one_torch_thread  # noqa: F401


TOL = 1e-5          # op_test's output tolerance
GRAD_TOL = 5e-3     # op_test's gradient tolerance
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
_R = np.random.RandomState(21)


def _f(*shape):
    return _R.randn(*shape).astype(np.float32)


# (case id, op type, inputs, output slots, attrs, gradient wrt slots)
_CASES = [
    ("concat_axis1", "concat", {"X": [_f(2, 3), _f(2, 5), _f(2, 1)]},
     ["Out"], {"axis": 1}, ["X"]),
    ("concat_axis2", "concat", {"X": [_f(2, 3, 4), _f(2, 3, 2)]}, ["Out"],
     {"axis": 2}, ["X"]),
    ("sigmoid", "sigmoid", {"X": _f(3, 7) * 3}, ["Out"], {}, ["X"]),
    ("tanh", "tanh", {"X": _f(3, 7) * 2}, ["Out"], {}, ["X"]),
    ("square_error_cost", "square_error_cost",
     {"X": _f(6, 1), "Label": _f(6, 1)}, ["Out"], {}, ["X"]),
]


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_book_op_matches_jax(case):
    _, op_type, inputs, outputs, attrs, wrt = case
    (jvals, jdecl), (tvals, tdecl) = _both(op_type, inputs, outputs, attrs)
    for n in jvals:
        assert tdecl[n] == jdecl[n], n
        np.testing.assert_allclose(tvals[n], jvals[n], atol=TOL, rtol=TOL,
                                   err_msg=n)
    jg, jdesc = _run_grad(pt, pt.Executor(), op_type, inputs, outputs,
                          attrs, outputs[0], wrt)
    tg, tdesc = _run_grad(ptt, ptt.Executor(ptt.CPUPlace()), op_type,
                          inputs, outputs, attrs, outputs[0], wrt)
    assert tdesc == jdesc
    assert len(tg) == len(jg) > 0
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t, j, atol=GRAD_TOL, rtol=GRAD_TOL)


def _split_program(pkg, x, attrs, n_out):
    """x -> split -> outputs; gradients of the first two outputs (given
    out-grads) back to x. Returns (outputs, dX, output declarations)."""
    main = pkg.Program()
    blk = main.global_block
    blk.create_var(name="x", shape=x.shape, dtype="float32")
    outs = [f"o{i}" for i in range(n_out)]
    blk.append_op("split", {"X": ["x"]}, {"Out": outs}, attrs)
    rs = np.random.RandomState(3)
    feed = {"x": x}
    for i in range(2):
        o = blk.var(outs[i])
        feed[f"d{i}"] = rs.randn(*o.shape).astype(np.float32)
        blk.create_var(name=f"d{i}", shape=o.shape, dtype="float32")
    dx, = pkg.gradients([blk.var(outs[0]), blk.var(outs[1])],
                        [blk.var("x")],
                        target_gradients=[blk.var("d0"), blk.var("d1")])
    exe = pkg.Executor() if pkg is pt else pkg.Executor(pkg.CPUPlace())
    vals = exe.run(main, feed=feed, fetch_list=outs + [dx.name])
    decl = [(tuple(blk.var(n).shape), blk.var(n).dtype) for n in outs]
    return [np.asarray(v) for v in vals[:-1]], np.asarray(vals[-1]), decl


@pytest.mark.parametrize("attrs,n_out", [({"num": 2, "axis": 1}, 2),
                                         ({"sections": [1, 3, 2],
                                           "axis": 2}, 3)],
                         ids=["num", "sections"])
def test_split_matches_jax(attrs, n_out):
    x = _f(2, 4, 6)
    jo, jdx, jdecl = _split_program(pt, x, attrs, n_out)
    to, tdx, tdecl = _split_program(ptt, x, attrs, n_out)
    assert tdecl == jdecl
    for t, j in zip(to, jo):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(tdx, jdx, atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# models: one step from the same weights
# ---------------------------------------------------------------------------

def build_both(build, optimizer=None):
    """`build(pkg)` -> dict with "loss" (and more) under each package's
    program_guard and unique_name_guard; `optimizer(pkg)` then minimizes
    the loss. Returns ((jmain, jstartup, jspec), (tmain, tstartup,
    tspec))."""
    out = []
    for pkg in (pt, ptt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name_guard(), pkg.program_guard(main, startup):
            spec = build(pkg)
            if optimizer is not None:
                optimizer(pkg).minimize(spec["loss"])
        out.append((main, startup, spec))
    return tuple(out)


def carry_startup(jmain, jstartup):
    """Run the JAX startup; returns (JAX scope, the port's scope holding the
    same persistables by name, the persistables' names)."""
    jscope = pt.Scope()
    pt.Executor().run(jstartup, scope=jscope)
    persist = [v.name for v in jmain.list_vars() if v.persistable
               and jscope.find_var(v.name) is not None]
    init = {n: np.asarray(jscope.find_var(n)) for n in persist}
    tscope = ptt.Scope()
    ptt.io.set_params_from_numpy(tscope, init, "cpu")
    return jscope, tscope, persist


def step_both(jprog, tprog, feed, fetch=("loss",)):
    """One run of each main program from the same startup values, fetching
    `fetch` (spec keys) and every parameter's gradient. Returns (jax, port)
    lists of numpy arrays and the parameter names."""
    (jmain, jstartup, jspec), (tmain, _, tspec) = jprog, tprog
    jscope, tscope, _ = carry_startup(jmain, jstartup)
    params = [p.name for p in jmain.global_block.all_parameters()
              if p.trainable]
    grads = [p + "@GRAD" for p in params]
    res = []
    for exe, main, spec, scope in (
            (pt.Executor(), jmain, jspec, jscope),
            (ptt.Executor(ptt.CPUPlace()), tmain, tspec, tscope)):
        vals = exe.run(main, feed=feed,
                       fetch_list=[spec[k] for k in fetch] + grads,
                       scope=scope)
        res.append([np.asarray(v) for v in vals])
    return res[0], res[1], params


def check_step(jprog, tprog, feed, fetch=("loss",)):
    """The programs match op for op (startup too); one step's fetches and
    gradients match JAX's."""
    assert _program_dict(tprog[0]) == _program_dict(jprog[0])
    assert _program_dict(tprog[1]) == _program_dict(jprog[1])
    j, t, params = step_both(jprog, tprog, feed, fetch)
    np.testing.assert_allclose(t[0], j[0], rtol=LOSS_RTOL)
    for name, a, b in zip(list(fetch[1:]) + params, j[1:], t[1:]):
        np.testing.assert_allclose(b, a, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
    return j, t


def _sgd(pkg):
    return pkg.optimizer.SGD(0.1)


def test_lenet_step_matches_jax():
    """LeNet-5 on an MNIST-shaped batch (the recognize_digits conv net)."""
    def build(pkg):
        img = pkg.layers.data("img", [1, 28, 28])
        label = pkg.layers.data("label", [1], dtype="int64")
        mod = jlenet if pkg is pt else tlenet
        logits = mod.lenet(img, 10)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, label))
        return {"loss": loss, "logits": logits}
    r = np.random.RandomState(0)
    feed = {"img": r.rand(8, 1, 28, 28).astype(np.float32),
            "label": r.randint(0, 10, (8, 1)).astype(np.int64)}
    check_step(*build_both(build, _sgd), feed, fetch=("loss", "logits"))


def test_vgg16_test_clone_forward_matches_jax():
    """image_classification_program("vgg16") at 32x32, 10 classes:
    programs equal, then the clone(for_test=True) forward."""
    def build(pkg):
        mod = jresnet if pkg is pt else tresnet
        return mod.image_classification_program("vgg16", 10, 32)
    jprog, tprog = build_both(build, _sgd)
    assert _program_dict(tprog[0]) == _program_dict(jprog[0])
    assert _program_dict(tprog[1]) == _program_dict(jprog[1])
    jscope, tscope, _ = carry_startup(jprog[0], jprog[1])
    r = np.random.RandomState(1)
    feed = {"img": r.randn(2, 3, 32, 32).astype(np.float32),
            "label": r.randint(0, 10, (2, 1)).astype(np.int64)}
    jtest = jprog[0].clone(for_test=True)
    ttest = tprog[0].clone(for_test=True)
    assert _program_dict(ttest) == _program_dict(jtest)
    j, = pt.Executor().run(jtest, feed=feed, scope=jscope,
                           fetch_list=[jprog[2]["logits"]])
    t, = ptt.Executor(ptt.CPUPlace()).run(ttest, feed=feed, scope=tscope,
                                          fetch_list=[tprog[2]["logits"]])
    assert t.shape == (2, 10)
    np.testing.assert_allclose(t, np.asarray(j), atol=TOL, rtol=TOL)


def test_fit_a_line_step_matches_jax():
    def build(pkg):
        return (jbook if pkg is pt else tbook).fit_a_line(13)
    r = np.random.RandomState(2)
    feed = {"x": r.randn(16, 13).astype(np.float32),
            "y": r.randn(16, 1).astype(np.float32)}
    check_step(*build_both(build, _sgd), feed, fetch=("loss", "pred"))


def _word2vec_step(is_sparse):
    def build(pkg):
        return (jbook if pkg is pt else tbook).word2vec(
            60, emb_dim=16, hidden=32, window=4, is_sparse=is_sparse)
    r = np.random.RandomState(3)
    feed = {f"context_{i}": r.randint(0, 60, (8, 1)).astype(np.int64)
            for i in range(4)}
    feed["target"] = r.randint(0, 60, (8, 1)).astype(np.int64)
    check_step(*build_both(build, _sgd), feed, fetch=("loss", "logits"))


def test_word2vec_step_matches_jax():
    """Four context words through one shared table, concat, sigmoid fc."""
    _word2vec_step(is_sparse=False)


def test_word2vec_sparse_step_matches_jax():
    """is_sparse=True: the shared table's four grads are SelectedRows,
    summed by concatenation (fetched dense), and the SGD step is a
    scatter-add of their rows."""
    _word2vec_step(is_sparse=True)


def test_recommender_step_matches_jax():
    """The twin-tower model at narrow vocabularies: tanh towers, the
    cosine of reduce_sum/sqrt, square_error_cost."""
    vocabs = dict(user_vocab=30, gender_vocab=2, age_vocab=7, job_vocab=5,
                  movie_vocab=40, category_vocab=6, title_vocab=50,
                  title_len=6, emb_dim=8)

    def build(pkg):
        return (jbook if pkg is pt else tbook).recommender(**vocabs)
    r = np.random.RandomState(4)
    ids = {"user_id": 30, "gender_id": 2, "age_id": 7, "job_id": 5,
           "movie_id": 40, "category_id": 6}
    feed = {k: r.randint(0, v, (8, 1)).astype(np.int64)
            for k, v in ids.items()}
    feed["movie_title"] = r.randint(0, 50, (8, 6)).astype(np.int64)
    feed["score"] = r.uniform(1, 5, (8, 1)).astype(np.float32)
    check_step(*build_both(build, _sgd), feed, fetch=("loss", "pred"))


def _nets_build(which):
    def build(pkg):
        nets = jnets if pkg is pt else tnets
        L = pkg.layers
        if which in ("simple_img_conv_pool", "img_conv_group"):
            img = L.data("img", [3, 12, 12])
            if which == "simple_img_conv_pool":
                h = nets.simple_img_conv_pool(img, 4, 3, 2, 2, act="relu")
            else:
                h = nets.img_conv_group(img, [4, 6], 2, conv_act="relu",
                                        conv_with_batchnorm=[True, False],
                                        pool_stride=2)
            out = L.fc(h, 5)
        else:
            x = L.data("x", [6, 8])
            if which == "glu":
                out = L.fc(nets.glu(L.fc(x, 10, num_flatten_dims=2),
                                    dim=-1), 5, num_flatten_dims=2)
            elif which == "switch_moe_ffn":
                out, aux = nets.switch_moe_ffn(x, 4, 8, 16)
                return {"loss": L.mean(out) + L.scale(aux, scale=0.01),
                        "out": out}
            elif which == "sequence_conv_pool":
                lens = L.data("lens", [], dtype="int64")
                out = nets.sequence_conv_pool(x, 5, 3, lengths=lens)
            else:
                out = nets.scaled_dot_product_attention(x, x, x, 2)
        return {"loss": L.mean(out), "out": out}
    return build


@pytest.mark.parametrize("which", ["simple_img_conv_pool", "img_conv_group",
                                   "glu", "scaled_dot_product_attention",
                                   "switch_moe_ffn", "sequence_conv_pool"])
def test_nets_helper_step_matches_jax(which):
    r = np.random.RandomState(5)
    if which in ("simple_img_conv_pool", "img_conv_group"):
        feed = {"img": r.randn(4, 3, 12, 12).astype(np.float32)}
    else:
        feed = {"x": r.randn(3, 6, 8).astype(np.float32)}
        if which == "sequence_conv_pool":
            feed["lens"] = np.array([6, 2, 4], np.int64)
    check_step(*build_both(_nets_build(which), _sgd), feed,
               fetch=("loss", "out"))


# ---------------------------------------------------------------------------
# the recurrent book models (dynamic_gru, the lstm stack, two StaticRNNs)
# at tests/test_book_models.py's shapes
# ---------------------------------------------------------------------------

def _seq2seq_feed(r, b=8, SV=30, TV=25, SL=7, TL=6):
    tin = r.randint(1, TV, (b, TL)).astype(np.int64)
    return {"src": r.randint(1, SV, (b, SL)).astype(np.int64),
            "src_lens": r.randint(3, SL + 1, (b, 1)).astype(np.int64),
            "tgt_in": tin, "tgt_out": (tin * 2 % TV).astype(np.int64),
            "tgt_lens": r.randint(2, TL + 1, (b, 1)).astype(np.int64)}


def test_seq2seq_attention_step_matches_jax():
    """The GRU encoder-decoder with Luong attention (bidirectional
    dynamic_gru over ragged source lengths)."""
    def build(pkg):
        return (jbook if pkg is pt else tbook).seq2seq_attention(
            30, 25, 7, 6, emb_dim=16, hidden=16)
    check_step(*build_both(build, _sgd), _seq2seq_feed(
        np.random.RandomState(6)), fetch=("loss", "logits"))


def test_srl_tagger_step_matches_jax():
    """label_semantic_roles: the depth-2 bidirectional dynamic_lstm stack
    over ragged lengths, masked token CE."""
    V, L, SL, b = 50, 9, 8, 8

    def build(pkg):
        return (jbook if pkg is pt else tbook).label_semantic_roles(
            V, L, SL, emb_dim=8, hidden=16, depth=2)
    r = np.random.RandomState(7)
    word = r.randint(0, V, (b, SL)).astype(np.int64)
    feed = {"word": word,
            "predicate": r.randint(0, V, (b, SL)).astype(np.int64),
            "mark": r.randint(0, 2, (b, SL)).astype(np.int64),
            "target": (word % L).astype(np.int64),
            "lens": r.randint(4, SL + 1, (b, 1)).astype(np.int64)}
    check_step(*build_both(build, _sgd), feed, fetch=("loss", "logits"))


def test_rnn_encoder_decoder_step_matches_jax():
    """Two StaticRNNs (recurrent and recurrent_grad) in one train step."""
    Ts, Tt, b = 6, 5, 16

    def build(pkg):
        return (jbook if pkg is pt else tbook).rnn_encoder_decoder(
            40, 40, Ts, Tt)
    r = np.random.RandomState(8)
    src = r.randint(1, 40, (b, Ts)).astype(np.int64)
    feed = {"src": src,
            "tgt_in": np.concatenate([src[:, :1] * 0 + 1, src[:, :Tt - 1]],
                                     axis=1).astype(np.int64),
            "tgt_out": src[:, :Tt].astype(np.int64),
            "tgt_lens": np.full((b, 1), Tt, np.int64)}
    jprog, tprog = build_both(build, _sgd)
    assert [op.type for op in tprog[0].global_block.ops].count(
        "recurrent") == 2
    check_step(jprog, tprog, feed, fetch=("loss", "logits"))
