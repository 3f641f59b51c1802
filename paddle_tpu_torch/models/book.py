"""The "book" model zoo: program builders for every model family the
reference exercises in its model-level integration tests
(python/paddle/fluid/tests/book/): fit_a_line, word2vec,
machine_translation (seq2seq + attention), recommender_system,
label_semantic_roles. recognize_digits lives in models/lenet.py,
image_classification in models/resnet.py + models/vgg.py.

Each builder appends to the CURRENT default programs (use inside
program_guard) and returns the vars a train loop needs.

Copied from `paddle_tpu/models/book.py`: fit_a_line, word2vec and
recommender build the JAX package's programs op for op. The three
recurrent models (seq2seq_attention, label_semantic_roles,
rnn_encoder_decoder) need dynamic_gru, lstm and StaticRNN, which come
with ROADMAP A.6 (control flow, LoD and RNN); until then they raise.
"""

from __future__ import annotations

from .. import layers


# ---------------------------------------------------------------------------
# fit_a_line (reference: tests/book/test_fit_a_line.py — linear regression)
# ---------------------------------------------------------------------------

def fit_a_line(feature_dim: int = 13):
    x = layers.data("x", [feature_dim], dtype="float32")
    y = layers.data("y", [1], dtype="float32")
    pred = layers.fc(x, size=1)
    loss = layers.mean(layers.square_error_cost(pred, y))
    return {"feed": ["x", "y"], "loss": loss, "pred": pred}


# ---------------------------------------------------------------------------
# word2vec (reference: tests/book/test_word2vec.py — N-gram neural LM)
# ---------------------------------------------------------------------------

def word2vec(vocab_size: int, emb_dim: int = 32, hidden: int = 256,
             window: int = 4, is_sparse: bool = False):
    """Predict the next word from `window` context words; context words
    share one embedding table (the reference passes a shared param_attr)."""
    from ..framework.layer_helper import ParamAttr
    shared = ParamAttr(name="shared_w2v_emb")
    embs = []
    feed = []
    for i in range(window):
        w = layers.data(f"context_{i}", [1], dtype="int64")
        feed.append(w.name)
        embs.append(layers.embedding(w, size=[vocab_size, emb_dim],
                                     param_attr=shared,
                                     is_sparse=is_sparse))
    target = layers.data("target", [1], dtype="int64")
    feed.append(target.name)
    concat = layers.concat([layers.squeeze(e, axes=[1]) for e in embs],
                           axis=1)
    h = layers.fc(concat, size=hidden, act="sigmoid")
    logits = layers.fc(h, size=vocab_size)
    loss = layers.mean(
        layers.softmax_with_cross_entropy(logits, target))
    return {"feed": feed, "loss": loss, "logits": logits}


# ---------------------------------------------------------------------------
# machine_translation (reference: tests/book/test_machine_translation.py —
# GRU encoder/decoder + attention, rnn_encoder_decoder variant)
# ---------------------------------------------------------------------------

def seq2seq_attention(src_vocab: int, tgt_vocab: int, src_len: int,
                      tgt_len: int, emb_dim: int = 32, hidden: int = 64):
    """Teacher-forced GRU encoder-decoder with Luong-style attention
    (`paddle_tpu/models/book.py` seq2seq_attention)."""
    raise NotImplementedError(
        "seq2seq_attention needs layers.dynamic_gru, which is not ported "
        "to paddle_tpu_torch yet (ROADMAP A.6: control flow, LoD and RNN)")


# ---------------------------------------------------------------------------
# recommender_system (reference: tests/book/test_recommender_system.py —
# twin-tower user/movie model, cosine similarity, rating regression)
# ---------------------------------------------------------------------------

def recommender(user_vocab: int = 6041, gender_vocab: int = 2,
                age_vocab: int = 7, job_vocab: int = 21,
                movie_vocab: int = 3953, category_vocab: int = 19,
                title_vocab: int = 5175, title_len: int = 8,
                emb_dim: int = 32):
    def _id_emb(name, vocab):
        v = layers.data(name, [1], dtype="int64")
        e = layers.embedding(v, size=[vocab, emb_dim])
        return v, layers.squeeze(e, axes=[1])

    uid, uid_e = _id_emb("user_id", user_vocab)
    gen, gen_e = _id_emb("gender_id", gender_vocab)
    age, age_e = _id_emb("age_id", age_vocab)
    job, job_e = _id_emb("job_id", job_vocab)
    usr = layers.fc(layers.concat([uid_e, gen_e, age_e, job_e], axis=1),
                    200, act="tanh")

    mid, mid_e = _id_emb("movie_id", movie_vocab)
    cat, cat_e = _id_emb("category_id", category_vocab)
    title = layers.data("movie_title", [title_len], dtype="int64")
    title_e = layers.embedding(title, size=[title_vocab, emb_dim])
    title_pool = layers.reduce_mean(title_e, dim=1)   # CNN pool simplified
    mov = layers.fc(layers.concat([mid_e, cat_e, title_pool], axis=1),
                    200, act="tanh")

    sim = layers.reduce_sum(usr * mov, dim=1, keep_dim=True) / (
        layers.sqrt(layers.reduce_sum(usr * usr, dim=1, keep_dim=True))
        * layers.sqrt(layers.reduce_sum(mov * mov, dim=1, keep_dim=True))
        + 1e-9)
    pred = layers.scale(sim, scale=5.0)
    rating = layers.data("score", [1], dtype="float32")
    loss = layers.mean(layers.square_error_cost(pred, rating))
    return {"feed": ["user_id", "gender_id", "age_id", "job_id", "movie_id",
                     "category_id", "movie_title", "score"],
            "loss": loss, "pred": pred}


# ---------------------------------------------------------------------------
# label_semantic_roles (reference: tests/book/test_label_semantic_roles.py —
# SRL tagger: word+predicate embeddings, stacked bidirectional LSTM)
# ---------------------------------------------------------------------------

def label_semantic_roles(word_vocab: int, label_num: int, seq_len: int,
                         pred_vocab: int = None, emb_dim: int = 32,
                         hidden: int = 64, depth: int = 2):
    """Token tagger over a stacked bidirectional LSTM
    (`paddle_tpu/models/book.py` label_semantic_roles)."""
    raise NotImplementedError(
        "label_semantic_roles needs layers.lstm, which is not ported to "
        "paddle_tpu_torch yet (ROADMAP A.6: control flow, LoD and RNN)")


# ---------------------------------------------------------------------------
# rnn_encoder_decoder (reference: tests/book/test_rnn_encoder_decoder.py —
# the plain seq2seq book model whose encoder AND decoder are built with
# the step-wise RNN DSL rather than fused rnn ops)
# ---------------------------------------------------------------------------

def rnn_encoder_decoder(src_vocab: int, tgt_vocab: int, src_len: int,
                        tgt_len: int, emb_dim: int = 32, hidden: int = 64):
    """Teacher-forced seq2seq whose encoder and decoder are StaticRNN step
    blocks (`paddle_tpu/models/book.py` rnn_encoder_decoder)."""
    raise NotImplementedError(
        "rnn_encoder_decoder needs layers.StaticRNN, which is not ported "
        "to paddle_tpu_torch yet (ROADMAP A.6: control flow, LoD and RNN)")