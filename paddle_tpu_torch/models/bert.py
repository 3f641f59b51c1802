"""BERT encoder and its MLM pretrain step, built with the port's layers DSL.

Port of `paddle_tpu/models/bert.py`: the same layers, parameter names
("bert/l{i}/...") and attrs, so a program built here serializes like the
JAX package's and reads the same weights. `attn_impl="einsum"` composes
attention from einsum/softmax ops (plain torch on every device);
`attn_impl="fused"` goes through the fused_attention op with the padding
mask as a per-key bias, which on CUDA dispatches to the Hopper flash
kernels (flash_small_fwd/flash_small_bwd at 256 <= s <= 512, flash_fwd and
the tiled backward pair above). `amp=True` applies the bf16 rewrite of
`contrib/mixed_precision.py` before the backward, as in JAX.

Not ported yet, each raising NotImplementedError: optimizer="lamb",
pipeline_microbatches, recompute=True and context parallelism
(`BertConfig(cp_axis=...)`).
"""

from __future__ import annotations

import math

import paddle_tpu_torch as pt
from ..framework.layer_helper import ParamAttr
from ._common import attr as _attr, check_max_pos, ffn as _shared_ffn, \
    layer_norm as _ln

__all__ = ["BertConfig", "bert_encoder", "bert_pretrain_program",
           "tp_shardings", "flops_per_step"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden=768, layers=12, heads=12,
                 ffn=3072, max_pos=512, type_vocab=2, dropout=0.1,
                 init_range=0.02, attn_impl="einsum", cp_axis="",
                 seq_parallel="ring"):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.heads = heads
        self.ffn = ffn
        self.max_pos = max_pos
        self.type_vocab = type_vocab
        self.dropout = dropout
        self.init_range = init_range
        # "einsum" (composed graph, attention-prob dropout) | "fused"
        # (fused_attention op: flash kernels, no attention-prob dropout)
        self.attn_impl = attn_impl
        self.cp_axis = cp_axis
        self.seq_parallel = seq_parallel


def _not_ported(what, where):
    return NotImplementedError(
        f"bert: {what} is not ported to paddle_tpu_torch yet; it comes with "
        f"{where}")


def _attention(x, mask_4d, mask_k, cfg: BertConfig, prefix: str,
               is_test: bool):
    seq = int(x.shape[1])
    h, nh = cfg.hidden, cfg.heads
    hd = h // nh

    # b,s,n,d layout end to end, separate q/k/v projections (as in JAX)
    def proj(name):
        p = pt.layers.fc(x, h, num_flatten_dims=2,
                         param_attr=_attr(f"{prefix}/{name}.w", cfg),
                         bias_attr=ParamAttr(name=f"{prefix}/{name}.b"))
        return pt.layers.reshape(p, [0, seq, nh, hd])

    q, k, v = proj("q"), proj("k"), proj("v")
    if cfg.attn_impl == "fused":
        ctx = pt.layers.fused_attention(
            q, k, v, bias_k=mask_k, sm_scale=1.0 / math.sqrt(hd),
            cp_axis=cfg.cp_axis, seq_parallel=cfg.seq_parallel)
    else:
        q = pt.layers.scale(q, scale=1.0 / math.sqrt(hd))
        scores = pt.layers.einsum("bqnd,bknd->bnqk", q, k)
        scores = scores + mask_4d  # additive mask, broadcast (b,1,1,s)
        probs = pt.layers.softmax(scores, axis=-1)
        if cfg.dropout > 0:
            probs = pt.layers.dropout(
                probs, cfg.dropout, is_test=is_test,
                dropout_implementation="upscale_in_train")
        ctx = pt.layers.einsum("bnqk,bknd->bqnd", probs, v)
    ctx = pt.layers.reshape(ctx, [0, seq, h])
    return pt.layers.fc(ctx, h, num_flatten_dims=2,
                        param_attr=_attr(f"{prefix}/out.w", cfg),
                        bias_attr=ParamAttr(name=f"{prefix}/out.b"))


def bert_encoder(src_ids, sent_ids, input_mask, cfg: BertConfig,
                 is_test: bool = False, prefix: str = "bert",
                 cut_vars=None):
    """src_ids/sent_ids: int64 (-1, seq); input_mask: float32 (-1, seq),
    1 for a real token and 0 for padding. cut_vars (the pipeline cut
    points) is not ported."""
    if cut_vars is not None:
        raise _not_ported("cut_vars (pipeline cut points)",
                          "the parallelism slice (ROADMAP.md queue A.10)")
    if cfg.cp_axis:
        raise _not_ported("context parallelism (cp_axis)",
                          "the parallelism slice (ROADMAP.md queue A.10)")
    seq = int(src_ids.shape[1])
    check_max_pos(seq, cfg)

    word_emb = pt.layers.embedding(
        src_ids, size=[cfg.vocab_size, cfg.hidden],
        param_attr=_attr(f"{prefix}/word_embedding", cfg))
    pos_ids = pt.layers.arange(0, seq, dtype="int64")
    pos_emb = pt.layers.embedding(
        pos_ids, size=[cfg.max_pos, cfg.hidden],
        param_attr=_attr(f"{prefix}/pos_embedding", cfg))
    sent_emb = pt.layers.embedding(
        sent_ids, size=[cfg.type_vocab, cfg.hidden],
        param_attr=_attr(f"{prefix}/sent_embedding", cfg))

    emb = word_emb + sent_emb
    emb = emb + pos_emb  # (b,s,h) + (s,h) broadcast
    emb = _ln(emb, f"{prefix}/emb_ln")
    if cfg.dropout > 0:
        emb = pt.layers.dropout(emb, cfg.dropout, is_test=is_test,
                                dropout_implementation="upscale_in_train")

    # additive attention mask (b,1,1,s): 0 keep, -1e4 drop
    m = pt.layers.reshape(input_mask, [0, 1, 1, seq])
    neg = pt.layers.scale(m, scale=1e4, bias=-1e4)
    # per-key variant (b, s) for the fused path
    neg_k = (pt.layers.scale(input_mask, scale=1e4, bias=-1e4)
             if cfg.attn_impl == "fused" else None)

    x = emb
    for i in range(cfg.layers):
        p = f"{prefix}/l{i}"
        att = _attention(x, neg, neg_k, cfg, p, is_test)
        x = _ln(x + att, f"{p}/ln1")
        ff = _shared_ffn(x, cfg, p, names=("ffn1", "ffn2"))
        x = _ln(x + ff, f"{p}/ln2")
    return x


def bert_pretrain_program(cfg: BertConfig, seq_len: int, is_test=False,
                          learning_rate=1e-4, optimizer="adam",
                          amp=False, pipeline_microbatches=None,
                          recompute=False):
    """(main, startup, fetches) for an MLM pretraining step with tied output
    embeddings (logits over the full vocab at every position). amp=True
    applies the bf16 rewrite (f32 master weights); fetches carry "loss"."""
    if optimizer == "lamb":
        raise _not_ported("optimizer='lamb'",
                          "the optimizer slice (ROADMAP.md queue A.3)")
    if pipeline_microbatches:
        raise _not_ported("pipeline_microbatches (PipelineOptimizer)",
                          "the parallelism slice (ROADMAP.md queue A.10)")
    if recompute:
        raise _not_ported("recompute=True (transpiler/recompute.py)",
                          "the transpiler slice (ROADMAP.md queue A.11)")
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        src = pt.layers.data("src_ids", [seq_len], dtype="int64")
        sent = pt.layers.data("sent_ids", [seq_len], dtype="int64")
        mask = pt.layers.data("input_mask", [seq_len], dtype="float32")
        labels = pt.layers.data("mlm_labels", [seq_len], dtype="int64")

        enc = bert_encoder(src, sent, mask, cfg, is_test=is_test)

        # tied-softmax MLM head: logits = enc @ word_emb^T
        word_emb = main.global_block.var("bert/word_embedding")
        logits = pt.layers.matmul(enc, word_emb, transpose_y=True)
        loss = pt.layers.softmax_with_cross_entropy(logits, labels)
        mean_loss = pt.layers.mean(loss)

        if optimizer == "adam":
            opt = pt.optimizer.Adam(learning_rate)
        else:
            opt = pt.optimizer.SGD(learning_rate)
        if amp:
            from ..contrib.mixed_precision import decorate
            opt = decorate(opt)
        opt.minimize(mean_loss)
    return main, startup, {"loss": mean_loss}


def tp_shardings(cfg: BertConfig, prefix: str = "bert"):
    """Megatron-style tensor-parallel specs over mesh axis 'mp', by
    parameter name: column-parallel q/k/v/ffn1 (output dim), row-parallel
    out/ffn2 (input dim), embeddings on vocab. The port has no mesh yet;
    the table is kept so the parallelism slice reads the same plan."""
    spec = {f"{prefix}/word_embedding": ("mp", None)}
    for i in range(cfg.layers):
        p = f"{prefix}/l{i}"
        for t in ("q", "k", "v"):
            spec[f"{p}/{t}.w"] = (None, "mp")
            spec[f"{p}/{t}.b"] = ("mp",)
        spec[f"{p}/out.w"] = ("mp", None)
        spec[f"{p}/ffn1.w"] = (None, "mp")
        spec[f"{p}/ffn1.b"] = ("mp",)
        spec[f"{p}/ffn2.w"] = ("mp", None)
    return spec


def flops_per_step(cfg: BertConfig, batch: int, seq: int) -> float:
    """Matmul FLOPs for one fwd+bwd train step (3x forward rule)."""
    h, s, b = cfg.hidden, seq, batch
    per_layer = 24 * b * s * h * h + 4 * b * s * s * h
    fwd = cfg.layers * per_layer + 2 * b * s * h * cfg.vocab_size
    return 3.0 * fwd
