"""ResNet-50 ImageNet train-step benchmark through the port's framework, on
one CUDA card.

    BATCH=128 STEPS=50 FMT=NCHW AMP=1 python3 -m \\
        paddle_tpu_torch.tools.bench_resnet50

Port of `tools/bench_resnet50.py`: the same flags (BATCH, STEPS, FMT
NCHW|NHWC, AMP 1|0, PEAK_TFLOPS; each also as BENCH_<name>), the same
program (`models.resnet.resnet50`, mean softmax cross-entropy,
`MomentumOptimizer(0.1, 0.9)`, with the bf16 AMP `decorate` when AMP=1), the
same protocol (the feed built once and moved to the card once, as the JAX
tool's `jnp.asarray` does; one warm-up step, then STEPS steps queued back to
back on that device-resident feed and one host sync at the end) and the
same FLOP convention, 3 * 2 * 4.089e9 * batch a step (4.089 GMAC an image
forward, x3 for forward and backward).
PEAK_TFLOPS defaults to the H100 SXM's dense peak for the run's type: 989.4
(bf16 tensor cores) with AMP, 67 (fp32 outside the tensor cores; TF32 is
off) without. It prints one JSON line with the JAX tool's `metric`, `value`
and `unit` keys (and the card's name and power limit); the JAX tool's
`vs_baseline` and `vs_jax_probe` ratios are left out, their denominators
being TPU measurements. It needs a CUDA card: `Executor()` runs on
CUDAPlace(0).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

FLOPS_PER_IMAGE = 3 * 2 * 4.089e9
PEAK_TFLOPS = {True: 989.4, False: 67.0}   # H100 SXM: bf16 / fp32


def build_program(amp=True, lr=0.1, fmt="NCHW"):
    """bench_resnet50's train program (224x224 images, 1000 classes):
    (main, startup, loss, logits)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import resnet
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name_guard(), ptt.program_guard(main, startup):
        shape = [3, 224, 224] if fmt == "NCHW" else [224, 224, 3]
        img = ptt.layers.data("img", shape, dtype="float32")
        label = ptt.layers.data("label", [1], dtype="int64")
        logits = resnet.resnet50(img, 1000, data_format=fmt)
        loss = ptt.layers.mean(
            ptt.layers.softmax_with_cross_entropy(logits, label))
        opt = ptt.optimizer.MomentumOptimizer(lr, 0.9)
        if amp:
            opt = ptt.contrib.mixed_precision.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss, logits


def feed(rng, batch, fmt="NCHW"):
    """U(0, 1) images and random labels, as the JAX tool feeds them."""
    shape = (batch, 3, 224, 224) if fmt == "NCHW" else (batch, 224, 224, 3)
    return {"img": rng.rand(*shape).astype(np.float32),
            "label": rng.randint(0, 1000, (batch, 1)).astype(np.int64)}


def to_device(data, device="cuda"):
    """A feed of numpy arrays as tensors on `device`, copied once, so that
    no step of a timed loop copies it from the host again."""
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in data.items()}


def main():
    import torch
    import paddle_tpu_torch as ptt

    def env(name, default):
        # this tool's flags and bench.py's BENCH_* spellings
        return os.environ.get(name, os.environ.get("BENCH_" + name, default))

    batch = int(env("BATCH", 128))
    steps = int(env("STEPS", 50))
    fmt = env("FMT", "NCHW")
    amp = env("AMP", "1") == "1"
    peak = float(env("PEAK_TFLOPS", PEAK_TFLOPS[amp])) * 1e12
    if not torch.cuda.is_available():
        print("bench_resnet50: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    main_prog, startup, loss, _ = build_program(amp=amp, fmt=fmt)
    data = to_device(feed(np.random.RandomState(0), batch, fmt))
    exe = ptt.Executor()
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    first, = exe.run(main_prog, feed=data, fetch_list=[loss], scope=scope)
    assert np.isfinite(first).all(), f"non-finite loss {first}"
    t0 = time.perf_counter()
    last = None
    for _ in range(steps):
        last = exe.run(main_prog, feed=data, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0]
    lv = float(last.float().reshape(()).item())      # host sync
    dt = (time.perf_counter() - t0) / steps
    assert np.isfinite(lv), f"non-finite loss {lv}"

    mfu = FLOPS_PER_IMAGE * batch / dt / peak
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "metric": "resnet50_train_mfu",
        "value": round(mfu, 4),
        "unit": "MFU (batch=%d %s amp=%d, %.1f img/s, %.1f ms/step, peak "
                "%.1f TFLOP/s)" % (batch, fmt, amp, batch / dt, dt * 1e3,
                                   peak / 1e12),
        "card": card,
    }))


if __name__ == "__main__":
    sys.exit(main())
