#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure (none catches its own
failure and goes on, nothing falls back to the CPU or to a plain version):

  1. build   -- compile every kernel of the path from ops/csrc/ with nvcc
                for sm_90a, one nvcc per source, all started together;
  2. kernels -- each kernel against its plain PyTorch version on the card:
                fp32 and bf16, causal or not, with and without a per-key
                bias, head dims from 4 to 256 (the kernels pad d to a
                multiple of 16), sq != sk and ragged lengths; one JSON line
                per case. Then attention_fwd_lse with the default dispatch
                at head dims 24, 40 and 96 must launch a kernel, and at 264
                (no kernel build) must raise, not run the plain path;
  3. serve   -- GPT-2 small (GPTConfig(): vocab 50257, hidden 768, 12
                layers, 12 heads) built with the port's DSL, initialized on
                CUDAPlace(0) from --seed, saved with save_inference_model at
                s=1024 and s=512 and loaded with create_predictor; 4
                requests of batch 2 at s=1024 (the tiled flash_fwd kernel)
                and 4 of batch 4 at s=512 (the single-pass flash_small_fwd
                kernel). Launch counts are zeroed just before the requests
                and read just after: each request must launch its kernel 12
                times. Each request's logits are held against the same
                program built with attn_impl="xla" (plain attention on the
                card) on the same scope: max abs difference <= 1e-3;
  4. times   -- each kernel at its main-path shape: CUDA-event time, the
                plain version's time, F.scaled_dot_product_attention's time
                as a yardstick only (the port never calls it), and the bound
                max(FLOPs / 67 TFLOP/s fp32 non-tensor, bytes / 3.35 TB/s)
                of an H100 SXM (NVIDIA's data sheet).

The line before the last is the {"kernels": [...]} summary; the last line is
{"ok": true, "device": {...}}. Full results go to chiprun_out/chip_smoke.json.
It exits non-zero before printing any result when no CUDA card is present
or when the paddle_tpu_torch package is not beside it.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
WORK_DIR = os.path.join(HERE, "_smoke_work")   # saved models, removed at exit

# H100 SXM peaks (NVIDIA H100 data sheet, dense): float32 outside the
# tensor cores, and HBM3 bandwidth. The fp32 kernels use plain FMAs (no
# TF32), so the fp32 non-tensor rate is their compute ceiling.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Kernel vs plain version. Both compute in f32 from the same inputs and
# differ in summation order: O and lse are held to FP32_TOL (atol and rtol)
# in every dtype, except that a bf16 O may round to the neighbouring bf16
# value, one ulp: at most 2^-7 of |O|.
FP32_TOL = 2e-5
BF16_ULP = 2.0 ** -7
LOGIT_TOL = 1e-3    # GPT-2 logits, flash program vs plain-attention program

KERNELS = {
    "flash_fwd": {
        "source": "paddle_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "paddle_tpu/ops/flash_attention.py:84",
    },
    "flash_small_fwd": {
        "source": "paddle_tpu_torch/ops/csrc/flash_small_fwd.cu",
        "replaces": "paddle_tpu/ops/flash_attention.py:266",
    },
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def preflight():
    """No result without a card and the package."""
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one "
             "CUDA card")
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        fail(f"the paddle_tpu_torch package is not beside {__file__}")
    sys.path.insert(0, HERE)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def _ptxas_summary(log):
    """{"<dtype>/d<D>": "N regs, S B spill"} per kernel instantiation from
    nvcc's -Xptxas -v output."""
    import re
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '.*?kernelI(f|13__nv_"
                      r"bfloat16)Li(\d+)E", ln)
        if m:
            cur = f"{'f32' if m.group(1) == 'f' else 'bf16'}/d{m.group(2)}"
            out[cur] = ""
        elif cur and "spill stores" in ln:
            out[cur] += ln.split(",")[1].strip().replace(" bytes", "B") + ", "
        elif cur and "registers" in ln:
            out[cur] += re.search(r"Used (\d+) registers", ln).group(1) + \
                " regs"
    return out


def phase_build():
    from paddle_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    took = cuda_build.build_all()
    wall = time.perf_counter() - t0
    ptxas = {}
    for name, log in cuda_build.build_logs.items():
        with open(os.path.join(OUT_DIR, f"build_{name}.log"), "w") as f:
            f.write(log)
        ptxas[name] = _ptxas_summary(log)
    emit({"phase": "build", "wall_s": round(wall, 3),
          "per_source_s": {k: round(v, 3) for k, v in took.items()}})
    for name, lines in ptxas.items():
        emit({"phase": "build", "kernel": name, "ptxas": lines})
    return {"wall_s": wall, "per_source_s": took, "ptxas": ptxas}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _inputs(bn, sq, sk, d, dtype, with_bias, seed):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    mk = lambda s: torch.randn((bn, s, d), generator=g, device="cuda",
                               dtype=torch.float32).to(dtype)
    q, k, v = mk(sq), mk(sk), mk(sk)
    bias = None
    if with_bias:
        keep = torch.rand((bn, sk), generator=g, device="cuda") > 0.1
        bias = torch.where(keep, torch.zeros((), device="cuda"),
                           torch.full((), -1e4, device="cuda"))
    return q, k, v, bias


def _compare(kernel, plain, q, k, v, bias, causal, sm):
    import torch
    o, lse = kernel(q, k, v, bias, causal, sm)
    torch.cuda.synchronize()
    o_ref, lse_ref = plain(q, k, v, bias, causal, sm)
    o_rtol = FP32_TOL if q.dtype == torch.float32 else BF16_ULP
    of, orf = o.float(), o_ref.float()
    err_o = (of - orf).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    ok = (bool(torch.isfinite(of).all()) and bool(torch.isfinite(lse).all())
          and bool(((of - orf).abs() <= FP32_TOL + o_rtol * orf.abs()).all())
          and bool(((lse - lse_ref).abs()
                    <= FP32_TOL + FP32_TOL * lse_ref.abs()).all()))
    return ok, err_o, err_l, o_rtol


def phase_kernels(seed):
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    cases = []
    for name, sizes in (("flash_small_fwd", (256, 384, 512)),
                        ("flash_fwd", (640, 1024, 2048))):
        for s in sizes:
            for d in (64, 128):
                for dtype in (torch.float32, torch.bfloat16):
                    for causal in (False, True):
                        for bias in (False, True):
                            cases.append((name, 8, s, s, d, dtype, causal,
                                          bias))
    # other head dims: the kernels run d % 4 == 0 up to 256, padded inside
    # to a multiple of 16
    for name, s in (("flash_small_fwd", 256), ("flash_fwd", 640)):
        for d in (4, 16, 24, 32, 40, 80, 96, 112, 200, 256):
            for dtype in (torch.float32, torch.bfloat16):
                for causal, bias in ((False, False), (True, True)):
                    cases.append((name, 8, s, s, d, dtype, causal, bias))
    # sq != sk (top-left causal alignment), and ragged lengths that are not
    # multiples of the kernels' tiles
    cases += [("flash_fwd", 8, 512, 1024, 64, torch.float32, False, False),
              ("flash_fwd", 8, 512, 1024, 64, torch.float32, True, False),
              ("flash_fwd", 8, 1024, 512, 64, torch.float32, True, True),
              ("flash_fwd", 4, 1000, 1000, 64, torch.float32, True, True),
              ("flash_small_fwd", 8, 256, 512, 64, torch.float32, False,
               True),
              ("flash_small_fwd", 8, 256, 512, 64, torch.float32, True,
               False),
              ("flash_small_fwd", 4, 200, 333, 128, torch.bfloat16, True,
               True)]
    results = []
    worst = {}
    for i, (name, bn, sq, sk, d, dtype, causal, with_bias) in \
            enumerate(cases):
        kernel = getattr(fa, name)
        plain = getattr(fa, name + "_plain")
        q, k, v, bias = _inputs(bn, sq, sk, d, dtype, with_bias, seed + i)
        ok, err_o, err_l, o_rtol = _compare(kernel, plain, q, k, v, bias,
                                            causal, d ** -0.5)
        rec = {"phase": "kernel", "kernel": name, "bn": bn, "sq": sq,
               "sk": sk, "d": d, "dtype": str(dtype).split(".")[-1],
               "causal": causal, "bias": with_bias,
               "max_abs_err_o": err_o, "max_abs_err_lse": err_l,
               "atol": FP32_TOL, "o_rtol": o_rtol, "lse_rtol": FP32_TOL,
               "ok": ok}
        emit(rec)
        results.append(rec)
        if not ok:
            fail(f"{name} disagrees with its plain version: {rec}")
        key = (name, rec["dtype"])
        worst[key] = max(worst.get(key, 0.0), err_o, err_l)
    emit({"phase": "kernels", "cases": len(results),
          "worst": {f"{n}/{dt}": e for (n, dt), e in worst.items()}})
    return results + _dispatch_checks(seed)


def _dispatch_checks(seed):
    """flash_dispatch keeps the JAX rule: on the card every head dim with
    d % 8 == 0 goes to a kernel, and one that no kernel is built for
    raises instead of running the plain path."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    mk = lambda s, d: torch.randn((2, s, 3, d), generator=g, device="cuda")
    results = []
    for d, s in ((24, 256), (96, 256), (40, 640), (96, 1024)):
        q, k, v = mk(s, d), mk(s, d), mk(s, d)
        want = "flash_small_fwd" if fa._small_ok(s, s) else "flash_fwd"
        before = {n: getattr(fa, n).launches for n in KERNELS}
        o, _ = fa.attention_fwd_lse(q, k, v, causal=True)
        delta = {n: getattr(fa, n).launches - before[n] for n in KERNELS}
        ref = fa.mha_reference(q, k, v, None, True)
        err = (o - ref).abs().max().item()
        rec = {"phase": "dispatch", "d": d, "s": s, "launches": delta,
               "max_abs_err_vs_reference": err, "tol": FP32_TOL}
        emit(rec)
        results.append(rec)
        if delta != {n: int(n == want) for n in KERNELS}:
            fail(f"attention at d={d}, s={s} launched {delta}, expected one "
                 f"{want}")
        if not bool(((o - ref).abs() <= FP32_TOL + FP32_TOL * ref.abs())
                    .all()):
            fail(f"attention at d={d}, s={s} differs from mha_reference by "
                 f"{err}")
    q = mk(256, 264)
    try:
        fa.attention_fwd_lse(q, q, q, causal=True)
    except ValueError as e:
        emit({"phase": "dispatch", "d": 264, "s": 256, "raised": str(e)})
    else:
        fail("attention at d=264 ran although no kernel is built for it")
    return results


# ---------------------------------------------------------------------------
# phase 3: GPT-2 small through the inference Predictor
# ---------------------------------------------------------------------------

def phase_serve(seed):
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_lm_program
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = GPTConfig()                      # GPT-2 small, full width/depth
    shapes = ((1024, 2, "flash_fwd"), (512, 4, "flash_small_fwd"))
    exe = ptt.Executor(ptt.CUDAPlace(0))
    scope = ptt.Scope()
    dirs, ref_progs = {}, {}
    t0 = time.perf_counter()
    for i, (seq, batch, _) in enumerate(shapes):
        with ptt.unique_name_guard():
            main, startup, fetch = gpt_lm_program(cfg, seq, is_test=True)
        if i == 0:
            startup.random_seed = seed
            exe.run(startup, scope=scope)
        d = os.path.join(WORK_DIR, f"gpt2_s{seq}")
        ptt.io.save_inference_model(d, ["tokens"], [fetch["logits"]], exe,
                                    main_program=main, scope=scope)
        dirs[seq] = d
        # the same inference program with the plain attention path
        with ptt.unique_name_guard():
            rmain, _, rfetch = gpt_lm_program(GPTConfig(attn_impl="xla"),
                                              seq, is_test=True)
        rname = rfetch["logits"].name
        ref_progs[seq] = (rmain.clone(for_test=True)._prune([rname]), rname)
    n_params = sum(int(scope.find_var(v.name).numel())
                   for v in main.list_vars() if v.persistable
                   and scope.find_var(v.name) is not None)
    preds = {seq: ptt.inference.create_predictor(ptt.inference.Config(d))
             for seq, d in dirs.items()}
    setup_s = time.perf_counter() - t0
    for p in preds.values():
        if p.device.type != "cuda":
            fail(f"predictor runs on {p.device}, not on the card")

    rng = np.random.RandomState(seed)
    requests = [(seq, batch, kname,
                 rng.randint(0, cfg.vocab_size, (batch, seq)).astype("int64"))
                for seq, batch, kname in shapes for _ in range(4)]
    # one warm-up request per predictor (allocator growth, cuBLAS handles)
    for seq, batch, _ in shapes:
        preds[seq].run({"tokens": requests[0][3][:1, :seq].repeat(batch, 0)})
    torch.cuda.synchronize()

    names = list(KERNELS)
    outs = []
    for name in names:
        getattr(fa, name).launches = 0
    # ---- the main path: counts zeroed just before, read just after ----
    for seq, batch, kname, toks in requests:
        before = {n: getattr(fa, n).launches for n in names}
        t = time.perf_counter()
        logits, = preds[seq].run({"tokens": toks})
        ms = (time.perf_counter() - t) * 1e3
        delta = {n: getattr(fa, n).launches - before[n] for n in names}
        outs.append((seq, batch, kname, toks, logits, ms, delta))
    launches = {n: getattr(fa, n).launches for n in names}
    # -------------------------------------------------------------------

    records = []
    for i, (seq, batch, kname, toks, logits, ms, delta) in enumerate(outs):
        want = {n: (cfg.layers if n == kname else 0) for n in names}
        if delta != want:
            fail(f"request {i} (s={seq}) launched {delta}, expected {want}")
        if logits.shape != (batch, seq, cfg.vocab_size) or \
                not np.isfinite(logits).all():
            fail(f"request {i}: logits {logits.shape} not finite or of the "
                 "wrong shape")
        rmain, rlogits = ref_progs[seq]
        ref, = exe.run(rmain, feed={"tokens": toks}, fetch_list=[rlogits],
                       scope=scope)
        diff = float(np.abs(logits - ref).max())
        rec = {"phase": "request", "i": i, "seq": seq, "batch": batch,
               "ms": ms, "tokens_per_s": batch * seq / (ms / 1e3),
               "launches": delta, "max_abs_logit_diff": diff,
               "logit_std": float(logits.std())}
        emit(rec)
        records.append(rec)
        if not diff <= LOGIT_TOL:
            fail(f"request {i}: logits differ from the plain-attention "
                 f"program by {diff} > {LOGIT_TOL}")
    for name in names:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the main path")
    summary = {"phase": "serve", "model": "gpt2-small", "params": n_params,
               "setup_s": setup_s, "launches": launches}
    for seq, batch, _ in shapes:
        lat = sorted(r["ms"] for r in records if r["seq"] == seq)
        summary[f"s{seq}_b{batch}_median_ms"] = lat[len(lat) // 2]
        summary[f"s{seq}_b{batch}_tokens_per_s"] = \
            batch * seq / (lat[len(lat) // 2] / 1e3)
        # the same request with the logits left on the card: the rest of
        # the request time is their copy to the host
        toks = next(r[3] for r in requests if r[0] == seq)
        dev = []
        for _ in range(3):
            t = time.perf_counter()
            preds[seq].run({"tokens": toks}, return_numpy=False)
            torch.cuda.synchronize()
            dev.append((time.perf_counter() - t) * 1e3)
        summary[f"s{seq}_b{batch}_on_device_ms"] = sorted(dev)[1]
    emit(summary)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    return {"summary": summary, "requests": records, "launches": launches,
            "heads": cfg.heads, "head_dim": cfg.hidden // cfg.heads,
            "shapes": {kname: (batch * cfg.heads, seq)
                       for seq, batch, kname in shapes}}


# ---------------------------------------------------------------------------
# phase 4: times at the main-path shapes
# ---------------------------------------------------------------------------

def _bound(bn, sq, sk, d, causal, elem):
    """Least time (ms) for the work: FLOPs of the score and P.V products
    over the (query, key) pairs this mask keeps, against bytes of q, k, v
    and o read or written once plus the f32 lse."""
    if causal:   # top-left aligned: row r sees keys 0..r
        pairs = sum(min(r + 1, sk) for r in range(sq))
    else:
        pairs = sq * sk
    flops = 4.0 * bn * pairs * d
    nbytes = (2 * bn * sq * d + 2 * bn * sk * d) * elem + 4 * bn * sq
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops, nbytes


def phase_times(serve, seed):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.tools.profile_gpt import time_ms
    n, d = serve["heads"], serve["head_dim"]
    rows = []
    for name, (bn, s) in serve["shapes"].items():
        kernel = getattr(fa, name)
        plain = getattr(fa, name + "_plain")
        q, k, v, _ = _inputs(bn, s, s, d, torch.float32, False, seed)
        sm = d ** -0.5
        ok, err_o, err_l, _ = _compare(kernel, plain, q, k, v, None, True, sm)
        if not ok:
            fail(f"{name} disagrees with its plain version at the main-path "
                 "shape")
        ms = time_ms(lambda: kernel(q, k, v, None, True, sm))
        plain_ms = time_ms(lambda: plain(q, k, v, None, True, sm), iters=5)
        b = bn // n
        q4, k4, v4 = (t.view(b, n, s, d) for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True))
        bound_ms, bound_by, flops, nbytes = _bound(bn, s, s, d, True, 4)
        row = {"name": name, "route": "cuda",
               "source": KERNELS[name]["source"],
               "replaces": KERNELS[name]["replaces"],
               "launches": serve["launches"][name],
               "max_abs_err": max(err_o, err_l), "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms}
        emit({"phase": "time", "kernel": name, "bn": bn, "sq": s, "sk": s,
              "d": d, "dtype": "float32", "causal": True, "flops": flops,
              "bytes": nbytes, "ms": ms, "plain_ms": plain_ms,
              "library_ms": lib_ms, "bound_ms": bound_ms,
              "bound_by": bound_by,
              "tflops_per_s": flops / (ms * 1e-3) / 1e12})
        rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    preflight()
    import torch

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "setup", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32})
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    try:
        build = phase_build()
        kernels = phase_kernels(args.seed)
        serve = phase_serve(args.seed)
        rows = phase_times(serve, args.seed)
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "seed": args.seed,
                   "wall_s": time.perf_counter() - t0, "build": build,
                   "kernel_cases": kernels, "serve": serve["summary"],
                   "requests": serve["requests"], "kernels": rows}, f,
                  indent=1)
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
