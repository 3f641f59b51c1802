"""GPT-2-small causal-LM train step on one CUDA card: the port of
`tools/bench_gpt.py` (bench.py's BENCH_MODEL=gpt2).

    python3 -m paddle_tpu_torch.tools.bench_gpt
    BENCH_SEQ=512 BENCH_BATCH=16 BENCH_AMP=1 BENCH_ATTN=fused \\
        BENCH_STEPS=30 BENCH_TELEMETRY_STEPS=5 \\
        python3 -m paddle_tpu_torch.tools.bench_gpt

The JAX tool's defaults (s512, b16, AMP, `fused` attention, 30 steps, 5
telemetry steps) and order: the training program is built with a
`train_stats.StepLogger` installed (so `minimize` attaches the telemetry
tap), the logger is uninstalled for the timed loop (the executor then adds
no telemetry fetch), the program is verified (`analysis.verify_program`,
`verify_ms`), the timed loop runs (feed on the card once, one warm-up,
BENCH_STEPS steps with `return_numpy=False`, one synchronise), then a
telemetry segment of BENCH_TELEMETRY_STEPS steps with the logger installed
again sources `extra` from the metrics registry: `steps_per_s` (the p50 of
train_step_seconds), `recompiles_total` (1 expected: the telemetry fetches
change the fetch list, cause=fetch_list), `nan_steps`, `telemetry_steps`,
`grad_norm`, and `counted_flops`, the FLOPs torch counted on the
segment's compiling step (the generic grads' replayed forwards in, the
flash kernels out). One JSON line with the JAX tool's keys, plus the card's name
and power limit in `extra.device`. At these defaults the attention runs
on the single-pass flash kernels in bf16 (`flash_small_fwd`,
`flash_small_bwd`) through `fused_attention`, 12 launches each a step.

PEAK_TFLOPS defaults as in bench_bert (989.4 with AMP, 67 without);
BENCH_RECOMPUTE=1 raises (ROADMAP A.9), and so does BENCH_PROFILE
(`profiler.profiler()` is ROADMAP A.12).
"""

import json
import os
import sys
import time

import numpy as np

from .bench_bert import result_line, timed_steps
from .bench_resnet50 import PEAK_TFLOPS, to_device


def _registry_total(snap, name):
    fam = snap.get(name)
    if not fam:
        return 0.0
    return sum(s.get("value", 0.0) for s in fam["series"])


def run(cfg, seq, batch, steps, amp, device="cuda", tele_steps=5,
        peak_tflops=None):
    """The JAX tool's body for `cfg` on `device` ("cuda" or "cpu");
    returns the JSON object."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.models.gpt import flops_per_step, gpt_lm_program
    from paddle_tpu_torch.observability import get_registry, train_stats

    peak = float(peak_tflops if peak_tflops is not None
                 else PEAK_TFLOPS[amp]) * 1e12
    # Build with the telemetry tap attached (the StepLogger must be
    # installed at minimize() time), then uninstall for the timed loop:
    # without a logger the executor adds no telemetry fetches.
    if tele_steps:
        train_stats.install_step_logger(
            train_stats.StepLogger(policy="warn", peak_flops=peak))
    try:
        main_prog, startup, fetches = gpt_lm_program(
            cfg, seq, learning_rate=1e-4, amp=amp)
    finally:
        train_stats.uninstall_step_logger()

    # static pre-flight: the program must verify clean before any bench
    # time is spent on it; verify_ms pins its build-time-only cost
    t_v = time.perf_counter()
    vrep = analysis.verify_program(main_prog, fetch_list=[fetches["loss"]])
    verify_ms = (time.perf_counter() - t_v) * 1e3
    if vrep.errors:
        raise RuntimeError(
            f"program failed verification:\n{vrep.render()}")

    rng = np.random.RandomState(0)
    feed = to_device({"tokens": rng.randint(
        0, cfg.vocab_size, (batch, seq)).astype(np.int64)}, device)
    exe = ptt.Executor(ptt.CPUPlace() if device == "cpu" else None)
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    loss_var = fetches["loss"]
    dt, loss, peak_bytes = timed_steps(exe, main_prog, feed, loss_var,
                                       scope, steps, device)

    extra = {}
    if tele_steps:
        # telemetry segment: re-install the logger and run a few
        # per-step-synced steps; the registry sources the columns (one
        # recompile is expected: the telemetry fetches change the fetch
        # list, counted as cause=fetch_list)
        logger = train_stats.install_step_logger(
            train_stats.StepLogger(policy="warn", peak_flops=peak))
        try:
            for _ in range(tele_steps):
                exe.run(main_prog, feed=feed, fetch_list=[loss_var],
                        scope=scope)
        finally:
            train_stats.uninstall_step_logger()
        snap = get_registry().snapshot()
        hist = snap.get("train_step_seconds", {}).get("series")
        p50 = hist[0].get("p50") if hist else None
        extra = {
            "steps_per_s": round(1.0 / p50, 3) if p50 else None,
            "recompiles_total": _registry_total(
                snap, "executor_recompiles_total"),
            "nan_steps": _registry_total(snap, "nan_steps_total"),
            "telemetry_steps": logger.step_count,
            "grad_norm": (logger.recent(1) or [{}])[-1].get("grad_norm"),
            # FLOPs torch counted on the segment's first (compiling) step:
            # the replayed forwards of the generic grads included, the
            # flash kernels (bound through ctypes) not
            "counted_flops": ((logger.recent() or [{}])[0].get("compile")
                              or {}).get("flops"),
        }
        if device == "cpu":
            extra["steps_per_s"] = None   # a host time, not the card's
    extra.update(verify_ms=round(verify_ms, 1), loss=loss,
                 peak_bytes=peak_bytes, amp=amp, attn=cfg.attn_impl)
    return result_line("gpt2_small_train_mfu",
                       flops_per_step(cfg, batch, seq), dt, batch, seq,
                       peak, device, extra)


def main():
    import torch
    from paddle_tpu_torch.models.gpt import GPTConfig

    if os.environ.get("BENCH_RECOMPUTE", "0") == "1":
        raise NotImplementedError(
            "BENCH_RECOMPUTE=1: recompute is not ported to paddle_tpu_torch "
            "yet (ROADMAP A.9)")
    if os.environ.get("BENCH_PROFILE", ""):
        raise NotImplementedError(
            "BENCH_PROFILE: profiler.profiler() is not ported to "
            "paddle_tpu_torch yet (ROADMAP A.12)")
    if not torch.cuda.is_available():
        print("bench_gpt: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seq = int(os.environ.get("BENCH_SEQ", 512))
    cfg = GPTConfig(max_pos=max(1024, seq),
                    attn_impl=os.environ.get("BENCH_ATTN", "fused"))
    print(json.dumps(run(
        cfg, seq, int(os.environ.get("BENCH_BATCH", 16)),
        int(os.environ.get("BENCH_STEPS", 30)),
        os.environ.get("BENCH_AMP", "1") == "1",
        tele_steps=int(os.environ.get("BENCH_TELEMETRY_STEPS", 5)),
        peak_tflops=os.environ.get("PEAK_TFLOPS"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
