"""The "book" model zoo: program builders for every model family the
reference exercises in its model-level integration tests
(python/paddle/fluid/tests/book/): fit_a_line, word2vec,
machine_translation (seq2seq + attention), recommender_system,
label_semantic_roles. recognize_digits lives in models/lenet.py,
image_classification in models/resnet.py + models/vgg.py.

Each builder appends to the CURRENT default programs (use inside
program_guard) and returns the vars a train loop needs.

Copied from `paddle_tpu/models/book.py`: every builder, the three
recurrent ones included (seq2seq_attention over dynamic_gru,
label_semantic_roles over the bidirectional layers.lstm stack,
rnn_encoder_decoder over two StaticRNNs), builds the JAX package's
program op for op.
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
    """Teacher-forced training graph. Luong-style attention: the decoder
    GRU runs over the shifted target, its states attend over the encoder
    states, and the context feeds the output projection — expressed as one
    batched matmul+softmax over all steps instead of the
    reference's per-step DynamicRNN attention block
    (tests/book/test_machine_translation.py decoder)."""
    src = layers.data("src", [src_len], dtype="int64")
    src_lens = layers.data("src_lens", [1], dtype="int64")
    tgt_in = layers.data("tgt_in", [tgt_len], dtype="int64")
    tgt_out = layers.data("tgt_out", [tgt_len], dtype="int64")
    tgt_lens = layers.data("tgt_lens", [1], dtype="int64")

    # encoder: bidirectional GRU
    src_emb = layers.embedding(src, size=[src_vocab, emb_dim])
    fwd = layers.dynamic_gru(
        layers.fc(src_emb, 3 * hidden, num_flatten_dims=2, bias_attr=False),
        hidden, sequence_length=layers.squeeze(src_lens, axes=[1]))
    bwd = layers.dynamic_gru(
        layers.fc(src_emb, 3 * hidden, num_flatten_dims=2, bias_attr=False),
        hidden, sequence_length=layers.squeeze(src_lens, axes=[1]),
        is_reverse=True)
    enc = layers.concat([fwd, bwd], axis=2)          # [b, Ts, 2h]
    enc_proj = layers.fc(enc, hidden, num_flatten_dims=2, bias_attr=False)

    # decoder GRU over teacher-forced inputs
    tgt_emb = layers.embedding(tgt_in, size=[tgt_vocab, emb_dim])
    dec = layers.dynamic_gru(
        layers.fc(tgt_emb, 3 * hidden, num_flatten_dims=2, bias_attr=False),
        hidden, sequence_length=layers.squeeze(tgt_lens, axes=[1]))

    # attention: scores[b,Tt,Ts] = dec @ enc_proj^T, masked over src pad
    scores = layers.matmul(dec, layers.transpose(enc_proj, [0, 2, 1]))
    src_mask = layers.sequence_mask(layers.squeeze(src_lens, axes=[1]),
                                    maxlen=src_len)          # [b, Ts]
    neg = layers.scale(1.0 - layers.unsqueeze(src_mask, axes=[1]),
                       scale=-1e9)
    attn = layers.softmax(scores + neg, axis=-1)
    ctx = layers.matmul(attn, enc)                    # [b, Tt, 2h]

    out = layers.fc(layers.concat([dec, ctx], axis=2), hidden,
                    num_flatten_dims=2, act="tanh")
    logits = layers.fc(out, tgt_vocab, num_flatten_dims=2)

    ce = layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(tgt_out, axes=[2]))  # [b, Tt, 1]
    tgt_mask = layers.sequence_mask(layers.squeeze(tgt_lens, axes=[1]),
                                    maxlen=tgt_len)
    ce = layers.squeeze(ce, axes=[2]) * tgt_mask
    loss = layers.reduce_sum(ce) / (layers.reduce_sum(tgt_mask) + 1e-9)
    return {"feed": ["src", "src_lens", "tgt_in", "tgt_out", "tgt_lens"],
            "loss": loss, "logits": logits}


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
    """Token tagger. The reference tops this with linear_chain_crf; here the
    tagging loss is masked token-level softmax CE (CRF: future op)."""
    pred_vocab = pred_vocab or word_vocab
    word = layers.data("word", [seq_len], dtype="int64")
    predicate = layers.data("predicate", [seq_len], dtype="int64")
    mark = layers.data("mark", [seq_len], dtype="int64")
    target = layers.data("target", [seq_len], dtype="int64")
    lens = layers.data("lens", [1], dtype="int64")

    w_e = layers.embedding(word, size=[word_vocab, emb_dim])
    p_e = layers.embedding(predicate, size=[pred_vocab, emb_dim])
    m_e = layers.embedding(mark, size=[2, emb_dim])
    x = layers.concat([w_e, p_e, m_e], axis=2)

    out, _, _ = layers.lstm(x, hidden_size=hidden, num_layers=depth,
                            is_bidirec=True,
                            sequence_length=layers.squeeze(lens, axes=[1]),
                            last_states=False)
    logits = layers.fc(out, label_num, num_flatten_dims=2)
    ce = layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(target, axes=[2]))
    mask = layers.sequence_mask(layers.squeeze(lens, axes=[1]),
                                maxlen=seq_len)
    ce = layers.squeeze(ce, axes=[2]) * mask
    loss = layers.reduce_sum(ce) / (layers.reduce_sum(mask) + 1e-9)
    return {"feed": ["word", "predicate", "mark", "target", "lens"],
            "loss": loss, "logits": logits}


# ---------------------------------------------------------------------------
# rnn_encoder_decoder (reference: tests/book/test_rnn_encoder_decoder.py —
# the plain seq2seq book model whose encoder AND decoder are built with
# the step-wise RNN DSL rather than fused rnn ops)
# ---------------------------------------------------------------------------

def rnn_encoder_decoder(src_vocab: int, tgt_vocab: int, src_len: int,
                        tgt_len: int, emb_dim: int = 32, hidden: int = 64):
    """Teacher-forced seq2seq where both sides are StaticRNN step blocks
    (the reference builds these with fluid's StaticRNN/DynamicRNN DSL;
    here each StaticRNN is one differentiable `recurrent` op — see
    ops/control_flow_ops.py)."""
    src = layers.data("src", [src_len], dtype="int64")
    tgt_in = layers.data("tgt_in", [tgt_len], dtype="int64")
    tgt_out = layers.data("tgt_out", [tgt_len], dtype="int64")
    tgt_lens = layers.data("tgt_lens", [1], dtype="int64")

    src_emb = layers.embedding(src, size=[src_vocab, emb_dim])
    src_tm = layers.transpose(src_emb, [1, 0, 2])      # [T, b, d]
    b_like = layers.reduce_sum(src_emb, dim=[1, 2], keep_dim=False)
    boot = layers.fill_constant_batch_size_like(
        layers.unsqueeze(b_like, axes=[1]), [-1, hidden], "float32", 0.0)

    enc_rnn = layers.StaticRNN()
    with enc_rnn.step():
        x_t = enc_rnn.step_input(src_tm)
        prev = enc_rnn.memory(init=boot)
        h = layers.fc(input=[x_t, prev], size=hidden, act="tanh")
        enc_rnn.update_memory(prev, h)
        enc_rnn.step_output(h)
    enc_states = enc_rnn()                             # [T, b, h]
    enc_final = layers.reshape(
        layers.slice(enc_states, axes=[0], starts=[src_len - 1],
                     ends=[src_len]), [-1, hidden])

    tgt_emb = layers.embedding(tgt_in, size=[tgt_vocab, emb_dim])
    tgt_tm = layers.transpose(tgt_emb, [1, 0, 2])
    dec_rnn = layers.StaticRNN()
    with dec_rnn.step():
        y_t = dec_rnn.step_input(tgt_tm)
        prev = dec_rnn.memory(init=enc_final)
        h = layers.fc(input=[y_t, prev], size=hidden, act="tanh")
        dec_rnn.update_memory(prev, h)
        dec_rnn.step_output(h)
    dec_states = dec_rnn()                             # [T, b, h]
    dec_bm = layers.transpose(dec_states, [1, 0, 2])   # [b, T, h]
    logits = layers.fc(dec_bm, tgt_vocab, num_flatten_dims=2)

    ce = layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(tgt_out, axes=[2]))
    tgt_mask = layers.sequence_mask(layers.squeeze(tgt_lens, axes=[1]),
                                    maxlen=tgt_len)
    ce = layers.squeeze(ce, axes=[2]) * tgt_mask
    loss = layers.reduce_sum(ce) / (layers.reduce_sum(tgt_mask) + 1e-9)
    return {"feed": ["src", "tgt_in", "tgt_out", "tgt_lens"],
            "loss": loss, "logits": logits}
