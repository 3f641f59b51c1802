"""Transformer NMT encoder-decoder (the BASELINE.json 'Transformer NMT
seq2seq' config; reference-era equivalent: the dist_transformer.py test
model and nets.py scaled_dot_product_attention composed by hand).

Copied from `paddle_tpu/models/transformer.py`: pure DSL, so the programs
match the JAX package's op for op and the parameter names are JAX's
(weights carry across by name through `io.set_params_from_numpy`).
Attention is batched einsum in b,s,n,d layout (no hand-written kernel, as
in the JAX package: the products go to cuBLAS), sinusoidal positions via
the add_position_encoding op, causal + padding masks as additive biases,
teacher-forced training over padded batches with explicit lengths.
"""

from __future__ import annotations

import math

from .. import layers
from ..framework.layer_helper import ParamAttr


def _mha(q_in, kv_in, bias, hidden, heads, prefix):
    hd = hidden // heads
    seq_q = q_in.shape[1]
    seq_k = kv_in.shape[1]
    q = layers.fc(q_in, hidden, num_flatten_dims=2, bias_attr=False,
                  param_attr=ParamAttr(name=f"{prefix}_q.w"))
    k = layers.fc(kv_in, hidden, num_flatten_dims=2, bias_attr=False,
                  param_attr=ParamAttr(name=f"{prefix}_k.w"))
    v = layers.fc(kv_in, hidden, num_flatten_dims=2, bias_attr=False,
                  param_attr=ParamAttr(name=f"{prefix}_v.w"))
    q = layers.reshape(q, [0, seq_q, heads, hd])
    k = layers.reshape(k, [0, seq_k, heads, hd])
    v = layers.reshape(v, [0, seq_k, heads, hd])
    q = layers.scale(q, scale=hd ** -0.5)
    scores = layers.einsum("bqnd,bknd->bnqk", q, k)
    scores = scores + bias                      # additive mask [b,1,q,k]
    probs = layers.softmax(scores, axis=-1)
    ctx = layers.einsum("bnqk,bknd->bqnd", probs, v)
    ctx = layers.reshape(ctx, [0, seq_q, hidden])
    return layers.fc(ctx, hidden, num_flatten_dims=2,
                     param_attr=ParamAttr(name=f"{prefix}_o.w"))


def _ffn(x, hidden, ffn_dim, prefix):
    h = layers.fc(x, ffn_dim, num_flatten_dims=2, act="relu",
                  param_attr=ParamAttr(name=f"{prefix}_fc1.w"))
    return layers.fc(h, hidden, num_flatten_dims=2,
                     param_attr=ParamAttr(name=f"{prefix}_fc2.w"))


def _pre_post(x, sub, prefix):
    """post-norm residual block (original Transformer)."""
    return layers.layer_norm(x + sub, begin_norm_axis=2,
                             param_attr=ParamAttr(name=f"{prefix}_ln.s"),
                             bias_attr=ParamAttr(name=f"{prefix}_ln.b"))


def _pad_bias(lens_var, maxlen):
    """[b, s] 0/1 mask -> additive [b, 1, 1, s] bias."""
    mask = layers.sequence_mask(layers.squeeze(lens_var, axes=[1]),
                                maxlen=maxlen)
    neg = layers.scale(1.0 - mask, scale=-1e9)
    return layers.unsqueeze(neg, axes=[1, 2])


def transformer_nmt(src_vocab: int, tgt_vocab: int, src_len: int,
                    tgt_len: int, hidden: int = 64, heads: int = 4,
                    ffn_dim: int = 256, n_layers: int = 2):
    src = layers.data("src", [src_len], dtype="int64")
    src_lens = layers.data("src_lens", [1], dtype="int64")
    tgt_in = layers.data("tgt_in", [tgt_len], dtype="int64")
    tgt_out = layers.data("tgt_out", [tgt_len], dtype="int64")
    tgt_lens = layers.data("tgt_lens", [1], dtype="int64")

    src_bias = _pad_bias(src_lens, src_len)           # [b,1,1,Ts]
    tgt_pad = _pad_bias(tgt_lens, tgt_len)            # [b,1,1,Tt]
    # causal mask, built once as a constant triangle
    tri = layers.fill_constant([tgt_len, tgt_len], "float32", 1.0)
    causal = layers.scale(
        layers.unsqueeze(1.0 - layers.tril(tri), axes=[0, 1]), scale=-1e9)
    dec_self_bias = tgt_pad + causal                  # [b,1,Tt,Tt]

    # encoder
    x = layers.embedding(src, size=[src_vocab, hidden],
                         param_attr=ParamAttr(name="src_emb"))
    x = layers.add_position_encoding(x)
    for i in range(n_layers):
        x = _pre_post(x, _mha(x, x, src_bias, hidden, heads,
                              f"enc{i}_self"), f"enc{i}_a")
        x = _pre_post(x, _ffn(x, hidden, ffn_dim, f"enc{i}"),
                      f"enc{i}_f")
    enc_out = x

    # decoder (teacher-forced)
    y = layers.embedding(tgt_in, size=[tgt_vocab, hidden],
                         param_attr=ParamAttr(name="tgt_emb"))
    y = layers.add_position_encoding(y)
    for i in range(n_layers):
        y = _pre_post(y, _mha(y, y, dec_self_bias, hidden, heads,
                              f"dec{i}_self"), f"dec{i}_a")
        y = _pre_post(y, _mha(y, enc_out, src_bias, hidden, heads,
                              f"dec{i}_cross"), f"dec{i}_c")
        y = _pre_post(y, _ffn(y, hidden, ffn_dim, f"dec{i}"),
                      f"dec{i}_f")

    logits = layers.fc(y, tgt_vocab, num_flatten_dims=2,
                       param_attr=ParamAttr(name="proj.w"))
    ce = layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(tgt_out, axes=[2]))
    tgt_mask = layers.sequence_mask(layers.squeeze(tgt_lens, axes=[1]),
                                    maxlen=tgt_len)
    ce = layers.squeeze(ce, axes=[2]) * tgt_mask
    loss = layers.reduce_sum(ce) / (layers.reduce_sum(tgt_mask) + 1e-9)
    return {"feed": ["src", "src_lens", "tgt_in", "tgt_out", "tgt_lens"],
            "loss": loss, "logits": logits}


# ---------------------------------------------------------------------------
# Shared encoder-block pair for the dygraph<->static parity matrix
# (reference test_imperative_transformer / test_dist_transformer pattern:
# the SAME weights through both execution modes must match)
# ---------------------------------------------------------------------------

def encoder_block_weights(hidden, heads, ffn_dim, n_layers, vocab,
                          seed=11):
    """One flat numpy weight dict both builders consume."""
    import numpy as np
    rng = np.random.RandomState(seed)

    def mat(a, b):
        return (rng.randn(a, b) * 0.02).astype("float32")

    w = {"emb": mat(vocab, hidden), "cls.w": mat(hidden, vocab),
         "cls.b": np.zeros(vocab, "float32")}
    for i in range(n_layers):
        p = f"l{i}"
        for nm in ("q", "k", "v", "o"):
            w[f"{p}.{nm}.w"] = mat(hidden, hidden)
            w[f"{p}.{nm}.b"] = np.zeros(hidden, "float32")
        w[f"{p}.f1.w"] = mat(hidden, ffn_dim)
        w[f"{p}.f1.b"] = np.zeros(ffn_dim, "float32")
        w[f"{p}.f2.w"] = mat(ffn_dim, hidden)
        w[f"{p}.f2.b"] = np.zeros(hidden, "float32")
        for ln in ("ln1", "ln2"):
            w[f"{p}.{ln}.scale"] = np.ones(hidden, "float32")
            w[f"{p}.{ln}.bias"] = np.zeros(hidden, "float32")
    return w


def encoder_block_program(w, hidden, heads, ffn_dim, n_layers, seq_len,
                          vocab):
    """Static pre-LN encoder stack + mean-pool classifier over vocab.
    Returns (main, startup, loss)."""
    import math
    from ..framework.layer_helper import ParamAttr
    from ..initializer import NumpyArrayInitializer
    from ..framework.core import Program, program_guard

    def attr(name):
        return ParamAttr(name=name,
                         initializer=NumpyArrayInitializer(w[name]))

    main, startup = Program(), Program()
    with program_guard(main, startup):
        toks = layers.data("tokens", [seq_len], dtype="int64")
        label = layers.data("label", [1], dtype="int64")
        x = layers.embedding(toks, size=[vocab, hidden],
                             param_attr=attr("emb"))
        hd = hidden // heads
        for i in range(n_layers):
            p = f"l{i}"
            h = layers.layer_norm(x, begin_norm_axis=2,
                                  param_attr=attr(f"{p}.ln1.scale"),
                                  bias_attr=attr(f"{p}.ln1.bias"))

            def proj(nm):
                t = layers.fc(h, hidden, num_flatten_dims=2,
                              param_attr=attr(f"{p}.{nm}.w"),
                              bias_attr=attr(f"{p}.{nm}.b"))
                t = layers.reshape(t, [0, seq_len, heads, hd])
                return layers.transpose(t, [0, 2, 1, 3])
            q, k, v = proj("q"), proj("k"), proj("v")
            s = layers.matmul(q, k, transpose_y=True,
                              alpha=1.0 / math.sqrt(hd))
            ctx = layers.matmul(layers.softmax(s), v)
            ctx = layers.reshape(layers.transpose(ctx, [0, 2, 1, 3]),
                                 [0, seq_len, hidden])
            x = x + layers.fc(ctx, hidden, num_flatten_dims=2,
                              param_attr=attr(f"{p}.o.w"),
                              bias_attr=attr(f"{p}.o.b"))
            h = layers.layer_norm(x, begin_norm_axis=2,
                                  param_attr=attr(f"{p}.ln2.scale"),
                                  bias_attr=attr(f"{p}.ln2.bias"))
            h = layers.fc(h, ffn_dim, num_flatten_dims=2, act="relu",
                          param_attr=attr(f"{p}.f1.w"),
                          bias_attr=attr(f"{p}.f1.b"))
            x = x + layers.fc(h, hidden, num_flatten_dims=2,
                              param_attr=attr(f"{p}.f2.w"),
                              bias_attr=attr(f"{p}.f2.b"))
        pooled = layers.reduce_mean(x, dim=1)
        logits = layers.fc(pooled, vocab, param_attr=attr("cls.w"),
                           bias_attr=attr("cls.b"))
        loss = layers.mean(
            layers.softmax_with_cross_entropy(logits, label))
    return main, startup, loss


def make_dygraph_encoder(w, hidden, heads, ffn_dim, n_layers, vocab):
    """Eager twin of encoder_block_program in the JAX package's dygraph
    mode, which the port does not have yet."""
    raise NotImplementedError(
        "make_dygraph_encoder needs dygraph/, which is not ported to "
        "paddle_tpu_torch yet (ROADMAP A.12)")
