"""BERT-base MLM pretrain step (fwd+bwd+Adam) on one CUDA card: the port of
`bench.py`.

    python3 -m paddle_tpu_torch.tools.bench_bert
    BENCH_SEQ=128 BENCH_BATCH=128 BENCH_ATTN=einsum BENCH_AMP=1 \\
        BENCH_STEPS=30 python3 -m paddle_tpu_torch.tools.bench_bert

The same environment as `bench.py` (BENCH_SEQ 128, BENCH_BATCH 128,
BENCH_ATTN einsum, BENCH_AMP 1, BENCH_STEPS 30, PEAK_TFLOPS), the same
program (`models.bert.bert_pretrain_program`, Adam lr 1e-4, the bf16 AMP
rewrite with BENCH_AMP=1), the same protocol (the feed moved to the card
once, one warm-up step, BENCH_STEPS steps queued with `return_numpy=False`
on that feed, one synchronise at the end) and the same FLOP count
(`models.bert.flops_per_step`). It prints bench.py's one JSON line
(`metric` bert_base_train_mfu, `value`, `unit`, `vs_baseline` = MFU / 0.45,
the north-star target of BASELINE.md) with an `extra` object: the card's
name and power limit (`device`), ms a step, the loss of the last step and
the card's peak memory. PEAK_TFLOPS defaults to the H100 SXM's dense peak
for the run's type, 989.4 (bf16) with AMP and 67 (fp32 outside the tensor
cores; TF32 is off) without. BENCH_RECOMPUTE=1 raises: recompute is
ROADMAP A.9.

BENCH_MODEL=gpt2 and BENCH_MODEL=resnet50 run the port's `bench_gpt` and
`bench_resnet50` instead, as bench.py does. `run(...)` is the body, which a
caller can point at the CPU with a small config: there the device numbers
(`value`, `vs_baseline`) are None, not a CPU time under their names.
"""

import json
import os
import sys
import time

import numpy as np

from .bench_resnet50 import PEAK_TFLOPS, card_line, to_device

NORTH_STAR_MFU = 0.45   # BASELINE.md's target, bench.py's vs_baseline


def result_line(metric, flops, dt, batch, seq, peak, device, extra):
    """bench.py's JSON object for one timed loop: MFU from the model's
    FLOPs a step over the measured step time, on the card only."""
    if device == "cpu":
        mfu = None
        unit = ("MFU not measured: a CPU run (batch=%d seq=%d, %.1f "
                "ms/step on the host)" % (batch, seq, dt * 1e3))
    else:
        mfu = flops / dt / peak
        unit = ("MFU (batch=%d seq=%d, %.1f samples/s, %.1f ms/step, peak "
                "%.1f TFLOP/s)" % (batch, seq, batch / dt, dt * 1e3,
                                   peak / 1e12))
    return {"metric": metric,
            "value": round(mfu, 4) if mfu is not None else None,
            "unit": unit,
            "vs_baseline": round(mfu / NORTH_STAR_MFU, 4)
            if mfu is not None else None,
            "extra": dict(extra, device=card_line() if device != "cpu"
                          else "cpu",
                          **{"cpu_step_ms" if device == "cpu"
                             else "step_ms": dt * 1e3})}


def timed_steps(exe, main_prog, feed, loss, scope, steps, device):
    """One warm-up step, then `steps` steps queued back to back on the
    device-resident feed and one synchronise: (seconds a step, last loss,
    peak device bytes or None)."""
    import torch
    first, = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope)
    if not np.isfinite(first).all():
        raise FloatingPointError(f"non-finite warm-up loss {first}")
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last = None
    for _ in range(steps):
        last = exe.run(main_prog, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0]
    lv = float(last.float().reshape(()).item())      # host sync
    dt = (time.perf_counter() - t0) / steps
    if not np.isfinite(lv):
        raise FloatingPointError(f"non-finite loss {lv}")
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else None)
    return dt, lv, peak


def bert_feed(cfg, batch, seq):
    """bench.py's feed: random ids, segments and labels, an all-ones
    mask, from RandomState(0)."""
    rng = np.random.RandomState(0)
    return {
        "src_ids": rng.randint(0, cfg.vocab_size,
                               (batch, seq)).astype(np.int64),
        "sent_ids": rng.randint(0, 2, (batch, seq)).astype(np.int64),
        "input_mask": np.ones((batch, seq), np.float32),
        "mlm_labels": rng.randint(0, cfg.vocab_size,
                                  (batch, seq)).astype(np.int64),
    }


def run(cfg, seq, batch, steps, amp, device="cuda", peak_tflops=None):
    """Build bench.py's program for `cfg`, time `steps` steps on `device`
    ("cuda" or "cpu") and return the JSON object."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.bert import (bert_pretrain_program,
                                              flops_per_step)
    peak = float(peak_tflops if peak_tflops is not None
                 else PEAK_TFLOPS[amp]) * 1e12
    main_prog, startup, fetches = bert_pretrain_program(
        cfg, seq, learning_rate=1e-4, amp=amp)
    feed = to_device(bert_feed(cfg, batch, seq), device)
    exe = ptt.Executor(ptt.CPUPlace() if device == "cpu" else None)
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    dt, loss, peak_bytes = timed_steps(exe, main_prog, feed,
                                       fetches["loss"], scope, steps,
                                       device)
    return result_line("bert_base_train_mfu",
                       flops_per_step(cfg, batch, seq), dt, batch, seq,
                       peak, device,
                       {"loss": loss, "peak_bytes": peak_bytes,
                        "amp": amp, "attn": cfg.attn_impl})


def main():
    model = os.environ.get("BENCH_MODEL", "bert")
    if model == "resnet50":
        from . import bench_resnet50
        return bench_resnet50.main()
    if model == "gpt2":
        from . import bench_gpt
        return bench_gpt.main()
    import torch
    from paddle_tpu_torch.models.bert import BertConfig

    if os.environ.get("BENCH_RECOMPUTE", "0") == "1":
        raise NotImplementedError(
            "BENCH_RECOMPUTE=1: recompute is not ported to paddle_tpu_torch "
            "yet (ROADMAP A.9)")
    if not torch.cuda.is_available():
        print("bench_bert: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seq = int(os.environ.get("BENCH_SEQ", 128))
    cfg = BertConfig(attn_impl=os.environ.get("BENCH_ATTN", "einsum"),
                     max_pos=max(512, seq))  # BERT-base
    amp = os.environ.get("BENCH_AMP", "1") == "1"
    print(json.dumps(run(
        cfg, seq, int(os.environ.get("BENCH_BATCH", 128)),
        int(os.environ.get("BENCH_STEPS", 30)), amp,
        peak_tflops=os.environ.get("PEAK_TFLOPS"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
