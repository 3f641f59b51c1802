"""Where the time of a GPT-2 small inference request, or of a GPT-2 small,
BERT-base or ResNet-50 train step, goes, on one CUDA card.

    python3 -m paddle_tpu_torch.tools.profile_gpt [--seed N] [--iters N]
    python3 -m paddle_tpu_torch.tools.profile_gpt --train
        [--model gpt|bert|resnet50] [--seed N] [--iters N]

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

With --train it measures instead the GPT-2 small train step (Adam,
dropout 0.1) at the two shapes of chip_smoke.py's train phase (with
--model bert: the BERT-base MLM pretrain step with the bf16 AMP rewrite,
bert_pretrain_program(amp=True), at s=512 b=16 on the fused attention path
with each row's last 10-40 % padded, and at bench.py's s=128 b=128 on the
einsum path, dropout 0.1 at both; with --model resnet50: bench_resnet50's
step, ResNet-50 at batch 128, 224x224, NCHW, Momentum(0.1, 0.9) with the
bf16 AMP rewrite): the median step wall time, and a torch.profiler trace of
a few steps with the device time by kernel group (matmul, cuDNN conv
forward and backward, flash forward, flash backward, the forward replays of
the generic torch.func.vjp grads, batch_norm, ReLU, pooling, the optimizer,
elementwise, ...), by op type, and the device's idle share. Each op runs
inside a record_function range (and a generic grad's replay of its forward
inside a nested one), and a kernel is charged to the range its launch fell
in.

Prints one JSON line per measurement and writes chiprun_out/profile_gpt.json
(profile_<model>_train.json with --train). Device numbers come only from a
card: without one it exits non-zero.
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


_CONV_KERNELS = ("conv", "cudnn", "fprop", "dgrad", "wgrad", "winograd",
                 "implicit_gemm", "implicit_convolve")


def _group(name: str) -> str:
    n = name.lower()
    if "flash_fwd_kernel" in n or "flash_small_fwd_kernel" in n:
        return "flash attention (ours)"
    if any(k in n for k in _CONV_KERNELS):
        return "conv (cuDNN)"
    if "memcpy" in n and "dtoh" in n:
        return "memcpy DtoH (logits)"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset other"
    if "gemm" in n or "cutlass" in n or "xmma" in n or "nvjet" in n:
        # nvjet: cuBLAS's own kernels, its bf16 products among them
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


def device_time_ms(fn, iters=20, warmup=3):
    """Mean device time, in ms, of the kernels one call of `fn` launches,
    from a torch.profiler trace: the kernel's own time where the host's
    launch path takes longer than the kernel, so that `time_ms` measures
    the host."""
    import torch
    from torch.autograd import DeviceType
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events")
    return sum(e.time_range.end - e.time_range.start
               for e in kernels) / iters / 1e3


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


_FLASH_FWD = ("flash_fwd_kernel", "flash_small_fwd_kernel")
_FLASH_BWD = ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel",
              "flash_small_bwd_kernel")
_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
             "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def _train_group(kernel: str, op: str, replay: bool) -> str:
    """Kernel group of a train step: our kernels and the generic-vjp
    replays first, then matmuls, then by the op that launched it."""
    if any(k in kernel for k in _FLASH_BWD):
        return "flash backward (ours)"
    if any(k in kernel for k in _FLASH_FWD):
        return "flash forward (ours)"
    if replay:
        return "generic-vjp forward replay"
    if op == "conv2d":
        return "conv forward (cuDNN)"
    if op == "conv2d_grad":
        return "conv backward (cuDNN)"
    g = _group(kernel)
    if g.startswith("matmul"):
        return g
    if op in ("adam", "momentum"):
        return op
    if op in ("batch_norm", "batch_norm_grad"):
        return "batch_norm (fwd+grad)"
    if op in ("relu", "relu_grad"):
        return "relu (fwd+grad)"
    if op in ("pool2d", "pool2d_grad"):
        return "pool2d (fwd+grad)"
    if op in ("cast", "cast_grad"):
        return "AMP casts (fwd+grad)"
    if op.startswith("softmax_with_cross_entropy"):
        return "softmax cross-entropy (fwd+grad)"
    if op in ("dropout", "dropout_grad"):
        return "dropout (fwd+grad)"
    return g


class _OpRanges:
    """While installed, every op the executor runs sits in a
    record_function range "op:<type>", and the forward rule a generic grad
    op replays under torch.func.vjp in a nested "replay:<type>"."""

    def __init__(self):
        from ..framework import registry
        self._reg = registry
        self._saved = {}
        self._in_grad = False

    def __enter__(self):
        import torch
        reg = self._reg
        lower_op, lower_grad = reg.lower_op, reg._lower_grad_op
        self._saved = {"lower_op": lower_op, "_lower_grad_op": lower_grad,
                       "defs": {t: d.lower for t, d in reg._REGISTRY.items()}}

        def op_range(ctx, op, env):
            with torch.profiler.record_function("op:" + op.type):
                return lower_op(ctx, op, env)

        def grad_op(ctx, op, env):
            self._in_grad = True
            try:
                return lower_grad(ctx, op, env)
            finally:
                self._in_grad = False

        def wrap(op_type, fn):
            def rule(ctx, ins, attrs):
                if not self._in_grad:
                    return fn(ctx, ins, attrs)
                with torch.profiler.record_function("replay:" + op_type):
                    return fn(ctx, ins, attrs)
            return rule

        for t, d in reg._REGISTRY.items():
            d.lower = wrap(t, d.lower)
        reg._lower_grad_op = grad_op
        from ..framework import executor
        executor.lower_op = op_range
        return self

    def __exit__(self, *exc):
        reg = self._reg
        for t, fn in self._saved["defs"].items():
            reg._REGISTRY[t].lower = fn
        reg._lower_grad_op = self._saved["_lower_grad_op"]
        from ..framework import executor
        executor.lower_op = self._saved["lower_op"]
        return False


def _attribute(events):
    """(device kernels, {kernel id: (op type, replayed)}): each kernel is
    charged to the innermost op/replay range that holds its launch (found
    through the launch's CUDA correlation id). The profiler mirrors each
    record_function range onto the device timeline as an annotation that
    spans the range's kernels; those are not kernels and are left out."""
    import bisect
    from torch.autograd import DeviceType
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("op:", "replay:"))]
    launch_at = {e.id: e.time_range.start for e in events
                 if e.device_type == DeviceType.CPU and e.name in _LAUNCHES}
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events if e.device_type == DeviceType.CPU
                    and e.name.startswith(("op:", "replay:")))
    starts = [r[0] for r in ranges]
    out = {}
    for k in kernels:
        t = launch_at.get(k.id)
        op, replay = "unattributed", False
        if t is not None:
            # the innermost range holding the launch began last; ops do
            # not overlap, so the op range is at most a replay range away
            i = bisect.bisect_right(starts, t) - 1
            for s, e, name in reversed(ranges[max(0, i - 3):i + 1]):
                if e < t:
                    continue
                if name.startswith("replay:"):
                    replay = True
                else:
                    op = name[3:]
                    break
        out[id(k)] = (op, replay)
    return kernels, out


def _train_cells(model, rng):
    """(label, seq, batch, program builder, feed) of each train cell; seq is
    None for an image model."""
    import numpy as np
    if model == "resnet50":
        from paddle_tpu_torch.tools import bench_resnet50 as bench

        def build():
            main, startup, loss, _ = bench.build_program(amp=True)
            return main, startup, {"loss": loss}
        return [("resnet50 b128 224 NCHW amp momentum", None, 128, build,
                 bench.feed(rng, 128))]
    if model == "gpt":
        from paddle_tpu_torch.models.gpt import GPTConfig, gpt_lm_program
        cfg = GPTConfig()
        return [(f"gpt2 s{seq} b{batch}", seq, batch,
                 lambda seq=seq: gpt_lm_program(cfg, seq),
                 {"tokens": rng.randint(0, cfg.vocab_size, (batch, seq))
                  .astype("int64")}) for seq, batch in ((1024, 2), (512, 4))]
    from paddle_tpu_torch.models.bert import BertConfig, bert_pretrain_program
    cells = []
    for seq, batch, impl, pad in ((512, 16, "fused", True),
                                  (128, 128, "einsum", False)):
        cfg = BertConfig(attn_impl=impl)
        mask = np.ones((batch, seq), np.float32)
        if pad:    # each row's last 10-40 % is padding
            real = seq - (rng.uniform(0.1, 0.4, batch) * seq).astype(int)
            mask = (np.arange(seq)[None] < real[:, None]).astype(np.float32)
        feed = {"src_ids": rng.randint(0, cfg.vocab_size, (batch, seq)),
                "sent_ids": rng.randint(0, 2, (batch, seq)),
                "input_mask": mask,
                "mlm_labels": rng.randint(0, cfg.vocab_size, (batch, seq))}
        cells.append((f"bert-base s{seq} b{batch} {impl} amp", seq, batch,
                       lambda cfg=cfg, seq=seq: bert_pretrain_program(
                           cfg, seq, amp=True), feed))
    return cells


def profile_train(seed, iters, sink, model="gpt"):
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt

    exe = ptt.Executor(ptt.CUDAPlace(0))
    rng = np.random.RandomState(seed)
    for label, seq, batch, build, feed in _train_cells(model, rng):
        with ptt.unique_name_guard():
            main, startup, fetch = build()
        startup.random_seed = main.random_seed = seed
        scope = ptt.Scope()
        exe.run(startup, scope=scope)

        def step():
            out, = exe.run(main, feed=feed,
                           fetch_list=[fetch["loss"]], scope=scope,
                           return_numpy=False)
            torch.cuda.synchronize()
            return out

        step()                                           # warm-up
        torch.cuda.reset_peak_memory_stats()
        ts = []
        for _ in range(iters):
            t = time.perf_counter()
            step()
            ts.append((time.perf_counter() - t) * 1e3)
        n_ops = len(main.global_block.ops)
        n_generic = sum(1 for op in main.global_block.ops
                        if op.type.endswith("_grad")
                        and _generic_grad(op.type))
        med = sorted(ts)[len(ts) // 2]
        rate = ({"img_per_s": batch / (med / 1e3)} if seq is None
                else {"tokens_per_s": batch * seq / (med / 1e3)})
        _emit({"phase": "train_step", "cell": label, "seq": seq,
               "batch": batch, "median_step_ms": med, "step_ms": ts,
               "ops": n_ops, "generic_vjp_grad_ops": n_generic,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               **rate}, sink)

        with _OpRanges(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(2):
                step()
            wall_us = (time.perf_counter() - t) * 1e6
        kernels, where = _attribute(prof.events())
        if not kernels:
            _emit({"phase": "train_profile", "cell": label,
                   "device_time": "not measured (the profiler recorded no "
                                  "device events)"}, sink)
            continue
        by_group, by_op, other = {}, {}, {}
        for k in kernels:
            us = k.time_range.end - k.time_range.start
            op, replay = where[id(k)]
            g = _train_group(k.name, op, replay)
            by_group[g] = by_group.get(g, 0.0) + us
            key = op + (" (replay)" if replay else "")
            by_op[key] = by_op.get(key, 0.0) + us
            if g == "other":
                other[k.name] = other.get(k.name, 0.0) + us
        busy = _union_us([(k.time_range.start, k.time_range.end)
                          for k in kernels])
        _emit({"phase": "train_profile", "cell": label, "seq": seq,
               "batch": batch, "steps": 2, "wall_ms_per_step": wall_us / 2e3,
               "device_busy_ms_per_step": busy / 2e3,
               "device_idle_share": 1.0 - busy / wall_us,
               "device_ms_per_step_by_group": {
                   k: v / 2e3 for k, v in sorted(by_group.items(),
                                                 key=lambda kv: -kv[1])},
               "device_ms_per_step_by_op": {
                   k: v / 2e3 for k, v in sorted(
                       by_op.items(), key=lambda kv: -kv[1])[:16]},
               "top_other_kernels_ms_per_step": [
                   [n[:90], v / 2e3] for n, v in sorted(
                       other.items(), key=lambda kv: -kv[1])[:6]]}, sink)
        del scope


def _generic_grad(grad_type: str) -> bool:
    from ..framework.registry import get_op_def
    return get_op_def(grad_type[: -len("_grad")]).grad_lower is None


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of inference")
    ap.add_argument("--model", choices=("gpt", "bert", "resnet50"),
                    default="gpt",
                    help="with --train: GPT-2 small, BERT-base with AMP, or "
                         "ResNet-50 at bench_resnet50's shape")
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
    if not (args.train and args.model == "resnet50"):
        # the GPT and BERT paths launch the flash kernels; no hand-written
        # kernel runs on the ResNet-50 path
        from paddle_tpu_torch.ops import cuda_build
        cuda_build.build_all()
    if args.train:
        profile_train(args.seed, args.iters, sink, args.model)
    else:
        dispatch_sweep(args.seed, sink)
        profile_requests(args.seed, args.iters, sink)
    out_dir = os.path.join(_ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = (f"profile_{args.model}_train.json" if args.train
            else "profile_gpt.json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(sink, f, indent=1)


if __name__ == "__main__":
    main()
