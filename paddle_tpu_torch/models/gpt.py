"""Decoder-only GPT language model (GPT-2: pre-LN blocks, learned positions,
tied LM head), built with the port's layers DSL.

Port of `paddle_tpu/models/gpt.py`: the same layers, parameter names and
attrs, so a program built here serializes like the JAX package's and reads
the same weights. Attention goes through the fused_attention op with
causal=True, which dispatches to the Hopper flash kernels on CUDA
(flash_fwd at s >= 640, flash_small_fwd at 256 <= s <= 512).

`gpt_lm_program` builds the train step (is_test=False, the JAX default:
append_backward + Adam, Lamb or SGD, amp=True for the bf16 AMP rewrite) or
the inference form (is_test=True). Not ported yet: recompute=True (it
raises) and `tp_shardings`.
"""

from __future__ import annotations

import math

import paddle_tpu_torch as pt
from ..framework.layer_helper import ParamAttr
from ._common import attr as _attr, check_max_pos, ffn as _ffn, \
    layer_norm as _ln

__all__ = ["GPTConfig", "gpt_decoder", "gpt_lm_program", "flops_per_step"]


class GPTConfig:
    def __init__(self, vocab_size=50257, hidden=768, layers=12, heads=12,
                 ffn=None, max_pos=1024, dropout=0.1, init_range=0.02,
                 attn_impl="fused", cp_axis="", seq_parallel="ring"):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.heads = heads
        self.ffn = ffn if ffn is not None else 4 * hidden
        self.max_pos = max_pos
        self.dropout = dropout
        self.init_range = init_range
        self.attn_impl = attn_impl
        self.cp_axis = cp_axis
        self.seq_parallel = seq_parallel


def _causal_attention(x, cfg: GPTConfig, prefix: str, seq: int):
    h, nh = cfg.hidden, cfg.heads
    hd = h // nh

    def proj(name):
        p = pt.layers.fc(x, h, num_flatten_dims=2,
                         param_attr=_attr(f"{prefix}/{name}.w", cfg),
                         bias_attr=ParamAttr(name=f"{prefix}/{name}.b"))
        return pt.layers.reshape(p, [0, seq, nh, hd])

    q, k, v = proj("q"), proj("k"), proj("v")
    ctx = pt.layers.fused_attention(
        q, k, v, causal=True, sm_scale=1.0 / math.sqrt(hd),
        impl=cfg.attn_impl if cfg.attn_impl != "fused" else "",
        cp_axis=cfg.cp_axis, seq_parallel=cfg.seq_parallel)
    ctx = pt.layers.reshape(ctx, [0, seq, h])
    return pt.layers.fc(ctx, h, num_flatten_dims=2,
                        param_attr=_attr(f"{prefix}/out.w", cfg),
                        bias_attr=ParamAttr(name=f"{prefix}/out.b"))


def gpt_decoder(tokens, cfg: GPTConfig, is_test=False, prefix="gpt"):
    """tokens: int64 (-1, seq) -> hidden states (-1, seq, h), pre-LN
    residual stack with a final LN (GPT-2)."""
    seq = int(tokens.shape[1])
    check_max_pos(seq, cfg)
    wte = pt.layers.embedding(
        tokens, size=[cfg.vocab_size, cfg.hidden],
        param_attr=_attr(f"{prefix}/wte", cfg))
    pos_ids = pt.layers.arange(0, seq, dtype="int64")
    wpe = pt.layers.embedding(
        pos_ids, size=[cfg.max_pos, cfg.hidden],
        param_attr=_attr(f"{prefix}/wpe", cfg))
    x = wte + wpe
    if cfg.dropout > 0:
        x = pt.layers.dropout(x, cfg.dropout, is_test=is_test,
                              dropout_implementation="upscale_in_train")

    def _resid_drop(t):
        # GPT-2 resid_pdrop on every sublayer output (training only)
        if cfg.dropout > 0 and not is_test:
            return pt.layers.dropout(
                t, cfg.dropout, is_test=is_test,
                dropout_implementation="upscale_in_train")
        return t

    for i in range(cfg.layers):
        p = f"{prefix}/l{i}"
        x = x + _resid_drop(
            _causal_attention(_ln(x, f"{p}/ln1"), cfg, p, seq))
        x = x + _resid_drop(_ffn(_ln(x, f"{p}/ln2"), cfg, p,
                                 names=("mlp1", "mlp2")))
    return _ln(x, f"{prefix}/lnf")


def gpt_lm_program(cfg: GPTConfig, seq_len: int, is_test=False,
                   learning_rate=1e-4, optimizer="adam", amp=False,
                   recompute=False):
    """(main, startup, fetches) for a causal-LM step: next-token CE with
    the tied wte head, loss over positions 0..seq-2 predicting 1..seq-1.
    With is_test=False the backward and the optimizer (`optimizer`:
    "adam", "lamb", else SGD) are appended; amp=True wraps the optimizer
    in the bf16 AMP rewrite (contrib.mixed_precision.decorate), as the JAX
    package does. Fetches carry "loss" and "logits"."""
    if recompute:
        raise NotImplementedError(
            "gpt_lm_program: recompute=True is not ported to "
            "paddle_tpu_torch yet (ROADMAP A.9)")
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        tokens = pt.layers.data("tokens", [seq_len], dtype="int64")
        h = gpt_decoder(tokens, cfg, is_test=is_test)
        wte = main.global_block.var("gpt/wte")
        logits = pt.layers.matmul(h, wte, transpose_y=True)
        # shift: logits[:, :-1] predict tokens[:, 1:]
        pred = pt.layers.slice(logits, [1], [0], [seq_len - 1])
        labels = pt.layers.slice(tokens, [1], [1], [seq_len])
        labels = pt.layers.reshape(labels, [0, seq_len - 1, 1])
        loss = pt.layers.softmax_with_cross_entropy(pred, labels)
        mean_loss = pt.layers.mean(loss)
        if optimizer == "adam":
            opt = pt.optimizer.Adam(learning_rate)
        elif optimizer == "lamb":
            opt = pt.optimizer.Lamb(learning_rate)
        else:
            opt = pt.optimizer.SGD(learning_rate)
        if amp:
            from ..contrib.mixed_precision import decorate
            opt = decorate(opt)
        if not is_test:
            opt.minimize(mean_loss)
    return main, startup, {"loss": mean_loss, "logits": logits}


def flops_per_step(cfg: GPTConfig, batch: int, seq: int) -> float:
    """Standard 6*N*tokens + attention-score terms (train = fwd + 2x bwd)."""
    h, L, ffn, v = cfg.hidden, cfg.layers, cfg.ffn, cfg.vocab_size
    per_tok = L * (4 * h * h + 2 * h * ffn) * 2   # qkvo + mlp matmuls, fwd
    attn = L * 2 * 2 * h * seq                    # scores + ctx per token
    head = 2 * h * v
    fwd = batch * seq * (per_tok + attn + head)
    return 3.0 * fwd
