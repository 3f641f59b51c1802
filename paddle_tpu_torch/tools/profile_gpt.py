"""Where the time of a GPT-2 small inference request goes, on one CUDA card.

    python3 -m paddle_tpu_torch.tools.profile_gpt [--seed N] [--iters N]

Builds GPT-2 small (GPTConfig()) with the port's DSL, initializes it on
CUDAPlace(0), prunes it to the logits as save_inference_model does, and
measures, for the two request shapes of chip_smoke.py (batch 2 at s=1024,
batch 4 at s=512):

  * request wall time with the logits copied to the host (what
    Predictor.run returns) and with them left on the card, and the copy
    alone, to fresh pageable memory and into a reused pinned buffer;
  * a torch.profiler trace of a few requests: device time by kernel
    group, the device's busy share of the wall time, and the top kernels;
  * the attention dispatch question: at s = 128..2048 (batch 2, 12 heads,
    d=64, fp32, causal), the time of `attention_fwd_lse` with impl="flash"
    (each Hopper kernel, through the (b, s, n, d) layout copies) and with
    impl="xla" (the plain path), each kernel alone, the picked kernel in
    bf16, and F.scaled_dot_product_attention (fp32 and bf16) as a
    yardstick only.

Prints one JSON line per measurement and writes chiprun_out/profile_gpt.json.
Device numbers come only from a card: without one it exits non-zero.
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _emit(obj, sink):
    sink.append(obj)
    print(json.dumps(obj), flush=True)


def _group(name: str) -> str:
    n = name.lower()
    if "flash_fwd_kernel" in n or "flash_small_fwd_kernel" in n:
        return "flash attention (ours)"
    if "memcpy" in n and "dtoh" in n:
        return "memcpy DtoH (logits)"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset other"
    if "gemm" in n or "sgemm" in n or "cutlass" in n or "xmma" in n:
        return "matmul (cuBLAS)"
    if "layer_norm" in n or "welford" in n or "var_mean" in n or \
            "reduce" in n:
        return "layer_norm / reductions"
    if "gelu" in n:
        return "gelu"
    if "index" in n or "embedding" in n or "gather" in n:
        return "embedding"
    if "copy" in n or "elementwise" in n or "vectorized" in n:
        return "elementwise / layout copies"
    return "other"


def _union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def time_ms(fn, iters=20, warmup=3):
    """Mean CUDA-event time of one call of `fn`, in ms, after `warmup`
    calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_requests(seed, iters, sink):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_lm_program

    cfg = GPTConfig()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    scope = ptt.Scope()
    rng = np.random.RandomState(seed)
    for i, (seq, batch) in enumerate(((1024, 2), (512, 4))):
        with ptt.unique_name_guard():
            main, startup, fetch = gpt_lm_program(cfg, seq, is_test=True)
        if i == 0:
            startup.random_seed = seed
            exe.run(startup, scope=scope)
        prog = main.clone(for_test=True)._prune([fetch["logits"].name])
        logits = fetch["logits"].name
        toks = rng.randint(0, cfg.vocab_size, (batch, seq)).astype("int64")

        def request(return_numpy):
            out, = exe.run(prog, feed={"tokens": toks}, fetch_list=[logits],
                           scope=scope, return_numpy=return_numpy)
            if not return_numpy:
                torch.cuda.synchronize()
            return out

        request(True)                                    # warm-up
        walls = {}
        for rn in (True, False):
            ts = []
            for _ in range(iters):
                t = time.perf_counter()
                request(rn)
                ts.append((time.perf_counter() - t) * 1e3)
            walls[rn] = sorted(ts)[len(ts) // 2]
        # the logits' copy alone: to fresh pageable memory (what
        # return_numpy does) and into a reused pinned buffer
        dev = request(False)
        pinned = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        copies = {}
        for kind, fn in (("pageable", lambda: dev.cpu()),
                         ("pinned", lambda: pinned.copy_(dev))):
            ts = []
            for _ in range(iters):
                t = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t) * 1e3)
            copies[kind] = sorted(ts)[len(ts) // 2]
        _emit({"phase": "request", "seq": seq, "batch": batch,
               "median_ms_to_host": walls[True],
               "median_ms_on_device": walls[False],
               "logits_bytes": dev.numel() * dev.element_size(),
               "copy_ms_pageable": copies["pageable"],
               "copy_ms_pinned": copies["pinned"]}, sink)
        del dev, pinned

        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(3):
                request(True)
            wall_us = (time.perf_counter() - t) * 1e6
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if not kernels:
            _emit({"phase": "profile", "seq": seq, "batch": batch,
                   "device_time": "not measured (the profiler recorded no "
                                  "device events)"}, sink)
            continue
        by_group, by_name = {}, {}
        for e in kernels:
            us = e.time_range.end - e.time_range.start
            by_group[_group(e.name)] = by_group.get(_group(e.name), 0) + us
            by_name[e.name] = by_name.get(e.name, 0) + us
        busy = _union_us([(e.time_range.start, e.time_range.end)
                          for e in kernels])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        _emit({"phase": "profile", "seq": seq, "batch": batch,
               "requests": 3, "wall_ms": wall_us / 1e3,
               "device_busy_ms": busy / 1e3,
               "device_idle_share": 1.0 - busy / wall_us,
               "device_ms_by_group": {k: v / 1e3 for k, v in sorted(
                   by_group.items(), key=lambda kv: -kv[1])},
               "top_kernels_ms": [[n[:90], v / 1e3] for n, v in top]},
              sink)


def dispatch_sweep(seed, sink):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa

    b, n, d = 2, 12, 64
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    for s in (128, 256, 384, 512, 640, 1024, 2048):
        q, k, v = (torch.randn((b, s, n, d), generator=g, device="cuda")
                   for _ in range(3))
        row = {"phase": "dispatch", "b": b, "s": s, "n": n, "d": d,
               "dtype": "float32", "causal": True,
               "flash_kernel": "flash_small_fwd" if fa._small_ok(s, s)
               else "flash_fwd"}
        row["flash_ms"] = time_ms(lambda: fa.attention_fwd_lse(
            q, k, v, causal=True, impl="flash"))
        row["xla_plain_ms"] = time_ms(lambda: fa.attention_fwd_lse(
            q, k, v, causal=True, impl="xla"))
        # each kernel alone on the (b*n, s, d) layout, where it applies
        qb, kb, vb = fa._to_bn(q), fa._to_bn(k), fa._to_bn(v)
        row["flash_fwd_kernel_ms"] = time_ms(
            lambda: fa.flash_fwd(qb, kb, vb, None, True, d ** -0.5))
        row["flash_small_fwd_kernel_ms"] = time_ms(
            lambda: fa.flash_small_fwd(qb, kb, vb, None, True, d ** -0.5))
        q4, k4, v4 = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        row["sdpa_library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=True))
        # bf16: the kernel the dispatch picks, and SDPA, on bf16 copies
        qh, kh, vh = (t.to(torch.bfloat16) for t in (qb, kb, vb))
        kern = getattr(fa, row["flash_kernel"])
        row["bf16_kernel_ms"] = time_ms(
            lambda: kern(qh, kh, vh, None, True, d ** -0.5))
        q4h, k4h, v4h = (t.view(b, n, s, d) for t in (qh, kh, vh))
        row["bf16_sdpa_library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(q4h, k4h, v4h,
                                                   is_causal=True))
        _emit(row, sink)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_gpt: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    sink = []
    _emit({"phase": "setup", "card": card, "torch": torch.__version__}, sink)
    from paddle_tpu_torch.ops import cuda_build
    cuda_build.build_all()
    dispatch_sweep(args.seed, sink)
    profile_requests(args.seed, args.iters, sink)
    out_dir = os.path.join(_ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_gpt.json"), "w") as f:
        json.dump(sink, f, indent=1)


if __name__ == "__main__":
    main()
