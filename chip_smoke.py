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
                (no kernel build) must raise, not run the plain path. Then
                the three backward kernels over the same kinds of cases
                (dQ, dK, dV and the bias grad db), each case launched twice
                and required to give the same bits. Then the two residual +
                LayerNorm kernels, fp32 and bf16, H 200/768/1024, M
                1/1000/16384, random or unit scale and bias, and bf16 at
                the spike's other shapes (8192 and 131072 rows of 768), the
                backward launched twice for the same bits, and fused_ln's
                autograd against autograd of torch_ln. Then the conv + BN
                kernels at the spike's five shapes, a ragged M (6272, 1000)
                and C = 200, conv_bn_stats launched twice for the same bits,
                and bn_apply_relu's one-value path (C % 8 != 0); then the
                head-slice Gram kernel at the repro's shape, a ragged one
                and a strided view;
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
  4. train   -- GPT-2 small (dropout 0.1) train programs with Adam through
                Executor.run on CUDAPlace(0): 3 steps at s=1024 b=2
                (flash_fwd, flash_bwd_dkv, flash_bwd_dq) and 3 at s=512
                b=4 (flash_small_fwd, flash_small_bwd). Counts are zeroed
                just before the steps and read just after: each kernel of
                the shape 12 times a step, the others never. Held against
                the attn_impl="xla" program run from a copy of the same
                scope: losses, step-1 gradients and the parameters after 3
                steps, to the tolerances stated below;
  5. bert    -- BERT-base (BertConfig(): vocab 30522, hidden 768, 12
                layers, 12 heads, ffn 3072) MLM pretrain steps through
                Executor.run on CUDAPlace(0). Held run at s=512 b=16 with
                each row's last 10-40 % padded, dropout 0: the
                attn_impl="fused" program (flash_small_fwd/flash_small_bwd
                with the mask as a per-key bias) against the
                attn_impl="einsum" program from a copy of the same scope, 3
                Adam steps in fp32 and 3 with the bf16 AMP rewrite, both
                from the same parameters and feeds: losses, step-1
                gradients (under AMP against the fp32 run's) and the
                parameters after 3 steps are held; counts
                zeroed just before each fused run's steps and read just
                after: 12 launches a step of each small kernel, none of the
                others. Then bench.py's shape (s=128 b=128, einsum, AMP,
                dropout 0.1, no flash kernel) for 3 steps. Step ms, tokens/s,
                peak memory and MFU for each run;
  6. resnet  -- ResNet-50 as tools/bench_resnet50.py builds it (224x224,
                1000 classes, NCHW, Momentum) through Executor.run and the
                inference Predictor on CUDAPlace(0): 3 fp32 steps at batch 4
                (lr 1e-3) held against the same program run on CPUPlace
                from the same values and feeds (step 1's loss, gradients,
                Momentum update and the BN running statistics it leaves;
                the losses of steps 2-3, where the trajectories part, to a
                looser bound; the card's own sensitivity to a 1e-7 input
                change beside it); the AMP program from
                the same values and feeds held against the fp32 run; the
                trained program's clone(for_test=True) saved and served at
                batch 8 by a Predictor on the card and one on the CPU;
                bench_resnet50's shape (batch 128, AMP, Momentum(0.1, 0.9)):
                median step, img/s, MFU, peak memory. No hand-written
                kernel runs on this path (its convs go to cuDNN): every
                count zeroed just before it and read just after stays 0;
  7. spike   -- the residual + LayerNorm spike's table
                (paddle_tpu_torch.tools.spike_residual_ln) at its four bf16
                shapes, the conv + BN spike's table (tools.spike_conv_bn)
                at ResNet-50's five bottleneck 1x1 convs, and the head-slice
                repro (tools.mosaic_repro_headslice), counts zeroed just
                before and read just after;
  8. times   -- each kernel at its main-path shape: CUDA-event time, the
                plain version's time, a library call's time as a yardstick
                only (the port never calls it: F.scaled_dot_product_attention
                forward or its backward alone through autograd;
                F.layer_norm(x + r) and aten's native_layer_norm_backward;
                the compositions torch.matmul + two column sums and
                torch.addcmul + relu; torch.bmm on the strided head slice),
                and the bound max(FLOPs / the peak of the operands' type
                (67 TFLOP/s fp32 non-tensor, 989.4 TFLOP/s bf16), bytes
                / 3.35 TB/s) of an H100 SXM (NVIDIA's data sheet); the two
                single-pass flash kernels also at BERT's shape, bf16 with a
                bias, and the conv + BN kernels at all five spike shapes.

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
# tensor cores (the rate for fp32 work with TF32 off), bf16 on the tensor
# cores, and HBM3 bandwidth. A bound takes the peak of its operands' type,
# whatever the kernel itself runs on.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989.4e12
PEAK_BYTES = 3.35e12

# Kernel vs plain version. Both compute in f32 from the same inputs and
# differ in summation order: O and lse are held to FP32_TOL (atol and rtol)
# in every dtype, except that a bf16 O may round to the neighbouring bf16
# value, one ulp: at most 2^-7 of |O|.
FP32_TOL = 2e-5
BF16_ULP = 2.0 ** -7
LOGIT_TOL = 1e-3    # GPT-2 logits, flash program vs plain-attention program

# Backward kernels vs their plain versions: dQ, dK, dV are sums over up to
# 2048 keys or query rows, taken in another order than the plain version's
# matmuls; held to BWD_TOL (atol and rtol) in fp32, and a bf16 output may
# round to the neighbouring bf16 value (one ulp, 2^-7 of |x|). db is f32.
BWD_TOL = 1e-4

# Residual + LayerNorm kernels vs their plain versions: out, mu, rstd and
# ds held to LN_TOL (atol and rtol), a bf16 out or ds may be one bf16 ulp
# away; dscale and dbias are sums over up to 16384 rows in another order,
# held to LN_SUM_RTOL of their largest value.
LN_TOL = 1e-5
LN_SUM_RTOL = 1e-4

# conv + BN spike kernels vs their plain versions (f32 from the same bf16
# inputs): y and the ReLU output within CBN_TOL + one bf16 ulp relative
# (the product's f32 sums are taken in another order, so y may round to the
# neighbouring bf16 value); s and q are sums over up to 401408 rows in
# another order, held to CBN_SUM_RTOL of their largest value.
CBN_TOL = 1e-5
CBN_SUM_RTOL = 1e-4
# head-slice Gram kernel vs its plain version (einsum, f32, TF32 off): sums
# over d in another order, GRAM_TOL atol and rtol
GRAM_TOL = 2e-5

# kernel -> its source, the TPU kernel it replaces, and whether the serving
# path (forward only) launches it; the GPT train path launches all five
# flash kernels, the BERT path the two single-pass ones, the spike the two
# residual + LayerNorm ones
KERNELS = {
    "flash_fwd": {
        "source": "paddle_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "paddle_tpu/ops/flash_attention.py:84",
        "serve": True,
    },
    "flash_small_fwd": {
        "source": "paddle_tpu_torch/ops/csrc/flash_small_fwd.cu",
        "replaces": "paddle_tpu/ops/flash_attention.py:266",
        "serve": True,
    },
    "flash_bwd_dkv": {
        "source": "paddle_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
        "replaces": "paddle_tpu/ops/flash_attention.py:134",
        "serve": False,
    },
    "flash_bwd_dq": {
        "source": "paddle_tpu_torch/ops/csrc/flash_bwd_dq.cu",
        "replaces": "paddle_tpu/ops/flash_attention.py:188",
        "serve": False,
    },
    "flash_small_bwd": {
        "source": "paddle_tpu_torch/ops/csrc/flash_small_bwd.cu",
        "replaces": "paddle_tpu/ops/flash_attention.py:279",
        "serve": False,
    },
    "residual_ln_fwd": {
        "source": "paddle_tpu_torch/ops/csrc/residual_ln_fwd.cu",
        "replaces": "tools/spike_residual_ln.py:44",
        "serve": False,
    },
    "residual_ln_bwd": {
        "source": "paddle_tpu_torch/ops/csrc/residual_ln_bwd.cu",
        "replaces": "tools/spike_residual_ln.py:55",
        "serve": False,
    },
    "conv_bn_stats": {
        "source": "paddle_tpu_torch/ops/csrc/conv_bn_stats.cu",
        "replaces": "tools/spike_conv_bn.py:26",
        "serve": False,
    },
    "bn_apply_relu": {
        "source": "paddle_tpu_torch/ops/csrc/bn_apply_relu.cu",
        "replaces": "tools/spike_conv_bn.py:88",
        "serve": False,
    },
    "headslice_gram": {
        "source": "paddle_tpu_torch/ops/csrc/headslice_gram.cu",
        "replaces": "tools/mosaic_repro_headslice.py:34",
        "serve": False,
    },
}
FLASH_KERNELS = [n for n in KERNELS if n.startswith("flash")]
LN_KERNELS = [n for n in KERNELS if n.startswith("residual_ln")]
CONV_BN_KERNELS = ["conv_bn_stats", "bn_apply_relu"]
FWD_KERNELS = [n for n, k in KERNELS.items() if k["serve"]]


def wrapper(name):
    """The Python wrapper of kernel `name`, which holds its launch count."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.tools import mosaic_repro_headslice as mrh
    from paddle_tpu_torch.tools import spike_conv_bn as scb
    from paddle_tpu_torch.tools import spike_residual_ln as srl
    return {"conv_bn_stats": scb.fused_conv_bn_stats,
            "bn_apply_relu": scb.bn_apply_relu,
            "headslice_gram": mrh.headslice_gram}.get(name) or getattr(
        fa if name in FLASH_KERNELS else srl, name)


def zero_counts(names):
    for n in names:
        wrapper(n).launches = 0


def read_counts(names):
    return {n: wrapper(n).launches for n in names}


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
        if "Compiling entry function" in ln:
            cur = None     # a kernel without template args is not listed
        m = re.search(r"Compiling entry function '.*?kernelI(f|13__nv_"
                      r"bfloat16)((?:Li\d+E)+)", ln)
        if m:
            ints = re.findall(r"Li(\d+)E", m.group(2))
            # flash kernels: <T, head dim>; residual LN: <T, VEC, NV>
            tag = f"d{ints[0]}" if len(ints) == 1 else \
                f"vec{ints[0]}/nv{ints[1]}"
            cur = f"{'f32' if m.group(1) == 'f' else 'bf16'}/{tag}"
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
          "per_source_s": {k: round(v, 3) for k, v in took.items()},
          "residual_ln_sources_s": {k: round(took[k], 3) for k in LN_KERNELS
                                    if k in took}})
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
    return results + _dispatch_checks(seed) + phase_bwd_kernels(seed) \
        + phase_ln_kernels(seed) + phase_conv_bn_kernels(seed) \
        + phase_gram_kernels(seed)


def _bwd_inputs(bn, sq, sk, d, dtype, with_bias, causal, seed):
    """q, k, v, bias as `_inputs`, plus dO and the saved o, lse and delta
    from the plain forward (so a backward case does not rest on a forward
    kernel)."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, bias = _inputs(bn, sq, sk, d, dtype, with_bias, seed)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 7919)
    do = torch.randn((bn, sq, d), generator=g, device="cuda").to(dtype)
    o, lse = fa.flash_small_fwd_plain(q, k, v, bias, causal, d ** -0.5)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    return q, k, v, bias, do, lse, delta


def _compare_bwd(name, args, causal, sm):
    """Kernel vs plain version on the same inputs, and a second launch that
    must give the same bits. Returns (ok, max_abs_err, bitwise)."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    kernel, plain = getattr(fa, name), getattr(fa, name + "_plain")
    got = kernel(*args, causal, sm)
    again = kernel(*args, causal, sm)
    torch.cuda.synchronize()
    ref = plain(*args, causal, sm)
    if name == "flash_bwd_dq":
        got, again, ref = (got,), (again,), (ref,)
    ok, err, bitwise = True, 0.0, True
    for a, a2, b in zip(got, again, ref):
        if b is None:
            ok = ok and a is None
            continue
        rtol = BWD_TOL if a.dtype == torch.float32 else BF16_ULP
        a, a2, b = a.float(), a2.float(), b.float()
        err = max(err, (a - b).abs().max().item())
        bitwise = bitwise and torch.equal(a, a2)
        ok = ok and bool(torch.isfinite(a).all()) and bool(
            ((a - b).abs() <= BWD_TOL + rtol * b.abs()).all())
    return ok and bitwise, err, bitwise


def phase_bwd_kernels(seed):
    """The three backward kernels against their plain versions: the shapes
    of the forward cases, and each case launched twice for bitwise
    reproducibility (no float atomics)."""
    import torch
    cases = []
    for names, sizes in ((("flash_small_bwd",), (256, 512)),
                         (("flash_bwd_dkv", "flash_bwd_dq"),
                          (640, 1024, 2048))):
        for name in names:
            for s in sizes:
                for d in (64, 128):
                    for dtype in (torch.float32, torch.bfloat16):
                        for causal in (False, True):
                            for bias in (False, True):
                                cases.append((name, 8, s, s, d, dtype,
                                              causal, bias))
    for names, s in ((("flash_small_bwd",), 256),
                     (("flash_bwd_dkv", "flash_bwd_dq"), 640)):
        for name in names:
            for d in (4, 16, 24, 40, 80, 96, 200, 256):
                for dtype in (torch.float32, torch.bfloat16):
                    for causal, bias in ((False, False), (True, True)):
                        cases.append((name, 4, s, s, d, dtype, causal, bias))
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        cases += [(name, 8, 512, 1024, 64, torch.float32, True, False),
                  (name, 8, 1024, 512, 64, torch.float32, True, True),
                  (name, 4, 1000, 1000, 64, torch.float32, True, True),
                  (name, 4, 1000, 1000, 64, torch.bfloat16, False, True)]
    cases += [("flash_small_bwd", 8, 256, 512, 64, torch.float32, True,
               True),
              ("flash_small_bwd", 8, 512, 256, 64, torch.float32, False,
               False),
              ("flash_small_bwd", 4, 200, 333, 128, torch.bfloat16, True,
               True),
              ("flash_small_bwd", 4, 200, 333, 64, torch.float32, False,
               True)]
    results, worst = [], {}
    for i, (name, bn, sq, sk, d, dtype, causal, with_bias) in \
            enumerate(cases):
        args = _bwd_inputs(bn, sq, sk, d, dtype, with_bias, causal,
                           seed + 1000 + i)
        ok, err, bitwise = _compare_bwd(name, args, causal, d ** -0.5)
        rec = {"phase": "bwd_kernel", "kernel": name, "bn": bn, "sq": sq,
               "sk": sk, "d": d, "dtype": str(dtype).split(".")[-1],
               "causal": causal, "bias": with_bias, "max_abs_err": err,
               "atol": BWD_TOL, "rtol": BWD_TOL if dtype == torch.float32
               else BF16_ULP, "bitwise_rerun": bitwise, "ok": ok}
        emit(rec)
        results.append(rec)
        if not ok:
            fail(f"{name} disagrees with its plain version or is not "
                 f"reproducible: {rec}")
        key = (name, rec["dtype"])
        worst[key] = max(worst.get(key, 0.0), err)
    emit({"phase": "bwd_kernels", "cases": len(results),
          "worst": {f"{n}/{dt}": e for (n, dt), e in worst.items()}})
    return results


def _ln_close(a, b, rtol):
    """(ok, max abs err): |a - b| <= LN_TOL + rtol * |b| everywhere."""
    import torch
    a, b = a.float(), b.float()
    return (bool(torch.isfinite(a).all())
            and bool(((a - b).abs() <= LN_TOL + rtol * b.abs()).all()),
            (a - b).abs().max().item())


def _sum_close(a, b):
    """(ok, max abs err) for a column sum: within LN_SUM_RTOL of max |b|."""
    import torch
    err = (a - b).abs().max().item()
    return (bool(torch.isfinite(a).all())
            and err <= LN_SUM_RTOL * b.abs().max().item(), err)


def phase_ln_kernels(seed):
    """The residual + LayerNorm kernels against their plain versions in
    every combination of dtype, H, M (1000 is ragged against the TPU
    kernel's 256-row blocks) and scale/bias (random, or 1 and 0), then at
    the spike's bf16 shapes the grid leaves out; each backward launched
    twice for the same bits. Then fused_ln's autograd against autograd of
    torch_ln."""
    import itertools
    import torch
    from paddle_tpu_torch.tools import spike_residual_ln as srl
    torch.manual_seed(seed)     # the cotangents g
    results, worst = [], {}
    cases = list(itertools.product((torch.float32, torch.bfloat16),
                                   (200, 768, 1024), (1, 1000, 16384),
                                   (False, True)))
    cases += [(torch.bfloat16, h, m, False) for m, h in srl.SHAPES
              if (torch.bfloat16, h, m, False) not in cases]
    for i, (dtype, h, m, unit) in enumerate(cases, 1):
        x, r, sc, b = srl.spike_inputs(m, h, dtype, seed + 3000 + i, unit)
        g = torch.randn(x.shape, device=x.device).to(dtype)
        rtol = LN_TOL if dtype == torch.float32 else BF16_ULP
        out, mu, rstd = srl.residual_ln_fwd(x, r, sc, b)
        ds, dsc, db = srl.residual_ln_bwd(x, r, sc, mu, rstd, g)
        again = srl.residual_ln_bwd(x, r, sc, mu, rstd, g)
        torch.cuda.synchronize()
        ref = srl.residual_ln_fwd_plain(x, r, sc, b)
        # the backward from the same saved mu, rstd on both sides, so it
        # does not rest on the forward kernel
        rds, rdsc, rdb = srl.residual_ln_bwd_plain(x, r, sc, mu, rstd, g)
        checks = {"out": _ln_close(out, ref[0], rtol),
                  "mu": _ln_close(mu, ref[1], LN_TOL),
                  "rstd": _ln_close(rstd, ref[2], LN_TOL),
                  "ds": _ln_close(ds, rds, rtol),
                  "dscale": _sum_close(dsc, rdsc),
                  "dbias": _sum_close(db, rdb)}
        bitwise = all(torch.equal(a, a2) for a, a2 in
                      zip((ds, dsc, db), again))
        ok = bitwise and all(c[0] for c in checks.values())
        rec = {"phase": "ln_kernel", "M": m, "H": h,
               "dtype": str(dtype).split(".")[-1],
               "scale_bias": "1/0" if unit else "random",
               "max_abs_err": {k: c[1] for k, c in checks.items()},
               "atol": LN_TOL, "rtol": rtol,
               "sum_rtol_of_max": LN_SUM_RTOL,
               "bitwise_rerun": bitwise, "ok": ok}
        emit(rec)
        results.append(rec)
        if not ok:
            fail(f"residual LN kernels disagree with their plain versions "
                 f"or are not reproducible: {rec}")
        for k, c in checks.items():
            key = (rec["dtype"], k)
            worst[key] = max(worst.get(key, 0.0), c[1])
        del x, r, g, out, ds, again, ref, rds
    # fused_ln (the kernels behind torch.autograd.Function) against
    # autograd of the plain composition torch_ln
    for dtype in (torch.float32, torch.bfloat16):
        x, r, sc, b = srl.spike_inputs(4096, 768, dtype, seed + 4000)
        g = torch.randn(x.shape, device=x.device).to(dtype)
        res = []
        for fn in (srl.fused_ln, srl.torch_ln):
            leaves = [t.detach().requires_grad_() for t in (x, r, sc, b)]
            out = fn(*leaves)
            res.append([out] + list(torch.autograd.grad(out, leaves, g)))
        rel = {}
        for k, a, want in zip(("out", "dx", "dr", "dscale", "dbias"), *res):
            rel[k] = ((a.float() - want.float()).abs().max()
                      / want.float().abs().max()).item()
        tol = 1e-4 if dtype == torch.float32 else BF16_ULP
        rec = {"phase": "ln_autograd", "M": 4096, "H": 768,
               "dtype": str(dtype).split(".")[-1],
               "max_err_rel_to_max": rel, "tol": tol,
               "ok": max(rel.values()) <= tol}
        emit(rec)
        results.append(rec)
        if not rec["ok"]:
            fail(f"fused_ln's gradients differ from torch_ln's: {rec}")
    emit({"phase": "ln_kernels", "cases": len(results),
          "worst": {f"{dt}/{k}": e for (dt, k), e in worst.items()}})
    return results


def _cbn_close(a, b):
    """(ok, max abs err): |a - b| <= CBN_TOL + one bf16 ulp * |b|."""
    import torch
    a, b = a.float(), b.float()
    return (bool(torch.isfinite(a).all())
            and bool(((a - b).abs() <= CBN_TOL + BF16_ULP * b.abs()).all()),
            (a - b).abs().max().item())


def _cbn_sum_close(a, b):
    """(ok, max abs err) for a column sum: within CBN_SUM_RTOL of max |b|."""
    import torch
    err = (a - b).abs().max().item()
    return (bool(torch.isfinite(a).all())
            and err <= CBN_SUM_RTOL * b.abs().max().item(), err)


def phase_conv_bn_kernels(seed):
    """The conv + BN spike's kernels against their plain versions at the
    spike's five shapes, the unfloored ragged M = 6272, M = 1000 with K and
    C that are multiples of 8 but not of the kernel's tiles, each
    conv_bn_stats launched twice for the same bits; bn_apply_relu also with
    C % 8 != 0 (its one-value path)."""
    import torch
    from paddle_tpu_torch.tools import spike_conv_bn as scb
    cases = list(scb.SHAPES) + [(6272, 2048, 512), (1000, 72, 200),
                                (1000, 64, 64)]
    results, worst = [], {}
    for i, (m, k, c) in enumerate(cases):
        x, w, _, _ = scb.spike_inputs(m, k, c, seed + 5000 + i)
        g = torch.Generator(device="cuda")
        g.manual_seed(seed + 5500 + i)
        gamma = torch.rand(c, generator=g, device="cuda") + 0.5
        beta = torch.randn(c, generator=g, device="cuda")
        y, s_, q = scb.fused_conv_bn_stats(x, w)
        again = scb.fused_conv_bn_stats(x, w)
        out = scb.bn_apply_relu(y, s_, q, gamma, beta)
        torch.cuda.synchronize()
        ry, rs, rq = scb.fused_conv_bn_stats_plain(x, w)
        # the second kernel from the first kernel's y, s and q on both sides
        rout = scb.bn_apply_relu_plain(y, s_, q, gamma, beta)
        checks = {"y": _cbn_close(y, ry), "s": _cbn_sum_close(s_, rs),
                  "q": _cbn_sum_close(q, rq), "out": _cbn_close(out, rout)}
        bitwise = all(torch.equal(a, b) for a, b in zip((y, s_, q), again))
        ok = bitwise and all(v[0] for v in checks.values())
        rec = {"phase": "conv_bn_kernel", "M": m, "K": k, "C": c,
               "dtype": "bfloat16",
               "max_abs_err": {n: v[1] for n, v in checks.items()},
               "atol": CBN_TOL, "rtol": BF16_ULP,
               "sum_rtol_of_max": CBN_SUM_RTOL, "bitwise_rerun": bitwise,
               "ok": ok}
        emit(rec)
        results.append(rec)
        if not ok:
            fail(f"conv+BN kernels disagree with their plain versions or "
                 f"are not reproducible: {rec}")
        for n, v in checks.items():
            worst[n] = max(worst.get(n, 0.0), v[1])
        del x, w, y, again, ry, out, rout
    for m, c in ((1000, 100), (4099, 36)):
        g = torch.Generator(device="cuda")
        g.manual_seed(seed + 5900 + c)
        y = torch.randn((m, c), generator=g, device="cuda") \
            .to(torch.bfloat16)
        s_ = y.float().sum(0)
        q = (y.float() ** 2).sum(0)
        gamma = torch.rand(c, generator=g, device="cuda")
        beta = torch.randn(c, generator=g, device="cuda")
        out = scb.bn_apply_relu(y, s_, q, gamma, beta)
        ok, err = _cbn_close(out, scb.bn_apply_relu_plain(y, s_, q, gamma,
                                                          beta))
        rec = {"phase": "conv_bn_kernel", "kernel": "bn_apply_relu",
               "M": m, "C": c, "max_abs_err": {"out": err}, "ok": ok}
        emit(rec)
        results.append(rec)
        if not ok:
            fail(f"bn_apply_relu disagrees with its plain version: {rec}")
    emit({"phase": "conv_bn_kernels", "cases": len(results),
          "worst": worst})
    return results


def phase_gram_kernels(seed):
    """The head-slice Gram kernel against its plain version at the repro's
    shape, a ragged one, and a (b, s, n, d) view of a (b, n, s, d) tensor
    (other strides); each launched twice for the same bits."""
    import torch
    from paddle_tpu_torch.tools import mosaic_repro_headslice as mrh
    results = []
    for i, (shape, view) in enumerate(((mrh.SHAPE, False),
                                       ((2, 200, 6, 40), False),
                                       ((3, 100, 4, 32), True))):
        g = torch.Generator(device="cuda")
        g.manual_seed(seed + 6000 + i)
        b, s_, n, d = shape
        if view:
            x = torch.rand((b, n, s_, d), generator=g,
                           device="cuda").permute(0, 2, 1, 3)
        else:
            x = torch.rand(shape, generator=g, device="cuda")
        got = mrh.headslice_gram(x)
        again = mrh.headslice_gram(x)
        torch.cuda.synchronize()
        want = mrh.headslice_gram_plain(x)
        diff = (got - want).abs()
        bitwise = torch.equal(got, again)
        ok = bitwise and bool(torch.isfinite(got).all()) and bool(
            (diff <= GRAM_TOL + GRAM_TOL * want.abs()).all())
        rec = {"phase": "gram_kernel", "shape": list(shape),
               "strides": list(x.stride()), "max_abs_err": diff.max().item(),
               "atol": GRAM_TOL, "rtol": GRAM_TOL, "bitwise_rerun": bitwise,
               "ok": ok}
        emit(rec)
        results.append(rec)
        if not ok:
            fail(f"headslice_gram disagrees with its plain version: {rec}")
    return results


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
        before = {n: getattr(fa, n).launches for n in FLASH_KERNELS}
        o, _ = fa.attention_fwd_lse(q, k, v, causal=True)
        delta = {n: getattr(fa, n).launches - before[n]
                 for n in FLASH_KERNELS}
        ref = fa.mha_reference(q, k, v, None, True)
        err = (o - ref).abs().max().item()
        rec = {"phase": "dispatch", "d": d, "s": s, "launches": delta,
               "max_abs_err_vs_reference": err, "tol": FP32_TOL}
        emit(rec)
        results.append(rec)
        if delta != {n: int(n == want) for n in FLASH_KERNELS}:
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

    names = FWD_KERNELS
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
# phase 4: GPT-2 small training steps
# ---------------------------------------------------------------------------

TRAIN_STEPS = 3
TRAIN_LR = 1e-4
LOSS_RTOL = 1e-4    # each step's loss, flash program vs plain-attention one
# Step-1 gradients, per tensor: max |g - g_ref| <= GRAD_RTOL * max |g_ref|
# + GRAD_ATOL. The atol covers tensors whose gradient is rounding noise:
# every l*/k.b (key bias) has an exact gradient of 0, since softmax is
# invariant to a per-row constant.
GRAD_RTOL = 1e-3
GRAD_ATOL = 1e-6
# Parameters after TRAIN_STEPS Adam steps. Adam normalises each gradient,
# so where the gradient is rounding noise (the k.b above) two correct
# programs may step about lr apart in opposite directions: up to 2 * lr a
# step.
PARAM_TOL = 2 * TRAIN_LR * TRAIN_STEPS + 1e-6


def _clone_scope(scope):
    import paddle_tpu_torch as ptt
    out = ptt.Scope()
    for n in scope.var_names():
        v = scope.find_var(n)
        out.set_var(n, v.clone() if hasattr(v, "clone") else v)
    return out


def phase_train(seed):
    """GPT-2 small train steps through Executor.run: 3 Adam steps at
    s=1024 b=2 (flash_fwd + flash_bwd_dkv + flash_bwd_dq) and at s=512 b=4
    (flash_small_fwd + flash_small_bwd), each against the same program
    built with attn_impl="xla" from a copy of the same scope."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_lm_program
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = GPTConfig()                      # GPT-2 small, dropout 0.1
    shapes = ((1024, 2, ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")),
              (512, 4, ("flash_small_fwd", "flash_small_bwd")))
    exe = ptt.Executor(ptt.CUDAPlace(0))
    rng = np.random.RandomState(seed)
    names = FLASH_KERNELS
    launches = {n: 0 for n in names}
    summaries = []
    for seq, batch, knames in shapes:
        t0 = time.perf_counter()
        progs = {}
        for impl in ("fused", "xla"):
            with ptt.unique_name_guard():
                progs[impl] = gpt_lm_program(
                    GPTConfig(attn_impl=impl), seq, learning_rate=TRAIN_LR)
            progs[impl][0].random_seed = seed
        main, startup, fetch = progs["fused"]
        startup.random_seed = seed
        scope = ptt.Scope()
        exe.run(startup, scope=scope)
        ref_scope = _clone_scope(scope)
        params = [p.name for p in main.global_block.all_parameters()]
        grads = [p + "@GRAD" for p in params]
        toks = [rng.randint(0, cfg.vocab_size, (batch, seq)).astype("int64")
                for _ in range(TRAIN_STEPS)]
        setup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        for n in names:
            getattr(fa, n).launches = 0
        # ---- the main path: counts zeroed just before, read just after ----
        losses, step_ms, g1 = [], [], None
        for i in range(TRAIN_STEPS):
            t = time.perf_counter()
            out = exe.run(main, feed={"tokens": toks[i]},
                          fetch_list=[fetch["loss"]] + (grads if i == 0
                                                         else []),
                          scope=scope, return_numpy=False)
            losses.append(float(out[0].item()))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            if i == 0:
                g1 = dict(zip(grads, out[1:]))
        delta = {n: getattr(fa, n).launches for n in names}
        # -------------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        want = {n: TRAIN_STEPS * cfg.layers if n in knames else 0
                for n in names}
        if delta != want:
            fail(f"train s={seq} b={batch} launched {delta}, expected "
                 f"{want}")
        for n in names:
            launches[n] += delta[n]

        rmain, _, rfetch = progs["xla"]
        ref_losses = []
        for i in range(TRAIN_STEPS):
            out = exe.run(rmain, feed={"tokens": toks[i]},
                          fetch_list=[rfetch["loss"]] + (grads if i == 0
                                                          else []),
                          scope=ref_scope, return_numpy=False)
            ref_losses.append(float(out[0].item()))
            if i == 0:
                rg1 = dict(zip(grads, out[1:]))
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        grad_ratio, grad_worst = -1.0, None
        for n in grads:
            diff = (g1[n] - rg1[n]).abs().max().item()
            tol = GRAD_RTOL * rg1[n].abs().max().item() + GRAD_ATOL
            if diff / tol > grad_ratio:
                grad_ratio, grad_worst = diff / tol, (n, diff, tol)
        param_diff, param_worst = 0.0, None
        for n in params:
            diff = (scope.find_var(n) - ref_scope.find_var(n)).abs().max() \
                .item()
            if diff > param_diff:
                param_diff, param_worst = diff, n
        med = sorted(step_ms)[len(step_ms) // 2]
        rec = {"phase": "train", "model": "gpt2-small", "seq": seq,
               "batch": batch, "optimizer": "adam", "lr": TRAIN_LR,
               "dropout": cfg.dropout, "steps": TRAIN_STEPS,
               "setup_s": setup_s, "step_ms": step_ms, "median_step_ms": med,
               "tokens_per_s": batch * seq / (med / 1e3),
               "max_memory_allocated": peak, "launches": delta,
               "losses": losses, "ref_losses": ref_losses,
               "loss_rel_diff": loss_rel, "loss_rtol": LOSS_RTOL,
               "grad_worst": {"var": grad_worst[0], "max_abs_diff":
                              grad_worst[1], "tol": grad_worst[2]},
               "param_max_abs_diff": param_diff, "param_worst": param_worst,
               "param_tol": PARAM_TOL}
        emit(rec)
        summaries.append(rec)
        if not all(np.isfinite(losses)) or max(loss_rel) > LOSS_RTOL:
            fail(f"train s={seq}: losses {losses} vs the plain-attention "
                 f"program's {ref_losses}")
        if grad_ratio > 1.0:
            fail(f"train s={seq}: step-1 gradient {grad_worst[0]} differs "
                 f"by {grad_worst[1]} > {grad_worst[2]}")
        if param_diff > PARAM_TOL:
            fail(f"train s={seq}: parameter {param_worst} differs by "
                 f"{param_diff} > {PARAM_TOL} after {TRAIN_STEPS} steps")
        del g1, rg1, scope, ref_scope
        torch.cuda.empty_cache()
    for n in names:
        if launches[n] == 0:
            fail(f"kernel {n} was not launched on the train path")
    return {"summaries": summaries, "launches": launches,
            "shapes": {n: (batch * cfg.heads, seq)
                       for seq, batch, knames in shapes for n in knames}}


# ---------------------------------------------------------------------------
# phase 5: BERT-base pretrain steps
# ---------------------------------------------------------------------------

BERT_LR = 1e-4
# The AMP runs, fused vs einsum program, both with bf16 AMP: the einsum
# program rounds scores and probabilities to bf16, the kernels keep them in
# f32. Losses: measured 8.3e-6 relative apart (H100 80GB HBM3, 700 W).
BERT_AMP_LOSS_RTOL = 1e-4
# AMP step-1 gradients, per tensor, against the exact ones (the fp32 fused
# run's, from the same parameters and feeds): max |g - g_fp32| <=
# BERT_AMP_GRAD_RTOL * max |g_fp32| + GRAD_ATOL, as the CPU test holds the
# port's AMP gradients against JAX's fp32 ones. Measured (H100, 700 W):
# worst 0.0186 * max |g| (l0/ln1.scale), and the einsum AMP program, which
# launches no kernel, 0.0187 (l1/v.w): bf16 rounding of the cotangents. A
# wrong bias or cast gradient is off by the order of max |g| itself.
BERT_AMP_GRAD_RTOL = 4e-2


def _bert_feed(rng, cfg, batch, seq, pad):
    """bench.py's feed; with pad=True each row's last 10-40 % are padding
    (input_mask 0), as ragged MLM batches have."""
    import numpy as np
    mask = np.ones((batch, seq), np.float32)
    if pad:
        real = seq - (rng.uniform(0.1, 0.4, batch) * seq).astype(int)
        mask = (np.arange(seq)[None] < real[:, None]).astype(np.float32)
    return {"src_ids": rng.randint(0, cfg.vocab_size,
                                   (batch, seq)).astype(np.int64),
            "sent_ids": rng.randint(0, 2, (batch, seq)).astype(np.int64),
            "input_mask": mask,
            "mlm_labels": rng.randint(0, cfg.vocab_size,
                                      (batch, seq)).astype(np.int64)}


def _bert_steps(exe, main, fetch, scope, feeds, grads):
    """One train step per feed; (losses, step ms, step-1 grads). Each step
    is timed on the host clock up to a synchronise."""
    import torch
    losses, step_ms, g1 = [], [], None
    for i, feed in enumerate(feeds):
        t = time.perf_counter()
        out = exe.run(main, feed=feed,
                      fetch_list=[fetch["loss"]] + (grads if i == 0 else []),
                      scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(out[0].item()))
        if i == 0:
            g1 = dict(zip(grads, out[1:]))
    return losses, step_ms, g1


def _grad_worst(grads, refs, rtol):
    """(worst diff / tol, var, diff, tol) over the tensors, tol = rtol *
    max |ref| + GRAD_ATOL."""
    worst = (-1.0, None, 0.0, 0.0)
    for n, ref in refs.items():
        diff = (grads[n].float() - ref.float()).abs().max().item()
        tol = rtol * ref.float().abs().max().item() + GRAD_ATOL
        worst = max(worst, (diff / tol, n, diff, tol))
    return worst


def _bert_rates(cfg, batch, seq, step_ms, amp):
    from paddle_tpu_torch.models.bert import flops_per_step
    med = sorted(step_ms)[len(step_ms) // 2]
    flops = flops_per_step(cfg, batch, seq)
    rec = {"median_step_ms": med, "tokens_per_s": batch * seq / (med / 1e3),
           "flops_per_step": flops,
           "mfu_vs_bf16_peak": flops / (med / 1e3) / PEAK_BF16_FLOPS}
    if not amp:
        # fp32 matmuls without TF32 run on FMAs: the fp32 non-tensor peak
        rec["mfu_vs_fp32_peak"] = flops / (med / 1e3) / PEAK_FP32_FLOPS
    return rec


def phase_bert(seed):
    """BERT-base through Executor.run on CUDAPlace(0): the held fused vs
    einsum runs at s=512 b=16 (fp32, then AMP), then bench.py's shape."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.bert import BertConfig, bert_pretrain_program
    from paddle_tpu_torch.ops import flash_attention as fa

    seq, batch = 512, 16
    cfg = BertConfig(dropout=0.0)
    exe = ptt.Executor(ptt.CUDAPlace(0))
    rng = np.random.RandomState(seed)
    # one set of feeds and of starting values for the fp32 and the AMP run,
    # so that the AMP gradients can be held against the fp32 ones
    feeds = [_bert_feed(rng, cfg, batch, seq, pad=True)
             for _ in range(TRAIN_STEPS)]
    launches = {n: 0 for n in FLASH_KERNELS}
    runs, init, exact = [], None, None
    for amp in (False, True):
        t0 = time.perf_counter()
        progs = {}
        for impl in ("fused", "einsum"):
            with ptt.unique_name_guard():
                progs[impl] = bert_pretrain_program(
                    BertConfig(attn_impl=impl, dropout=0.0), seq,
                    learning_rate=BERT_LR, amp=amp)
        main, startup, fetch = progs["fused"]
        startup.random_seed = seed
        scope = ptt.Scope()
        exe.run(startup, scope=scope)
        if init is None:
            init = _clone_scope(scope)
        else:
            for n in init.var_names():
                if n in scope:
                    v = init.find_var(n)
                    scope.set_var(n, v.clone() if hasattr(v, "clone") else v)
        ref_scope = _clone_scope(scope)
        params = [p.name for p in main.global_block.all_parameters()]
        grads = [p + "@GRAD" for p in params]
        setup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        for n in FLASH_KERNELS:
            getattr(fa, n).launches = 0
        # ---- the main path: counts zeroed just before, read just after ----
        losses, step_ms, g1 = _bert_steps(exe, main, fetch, scope, feeds,
                                          grads)
        delta = {n: getattr(fa, n).launches for n in FLASH_KERNELS}
        # -------------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        want = {n: TRAIN_STEPS * cfg.layers if n in ("flash_small_fwd",
                                                      "flash_small_bwd")
                else 0 for n in FLASH_KERNELS}
        if delta != want:
            fail(f"bert s={seq} amp={amp} launched {delta}, expected {want}")
        for n in FLASH_KERNELS:
            launches[n] += delta[n]

        rmain, _, rfetch = progs["einsum"]
        torch.cuda.reset_peak_memory_stats()
        ref_losses, ref_ms, rg1 = _bert_steps(exe, rmain, rfetch, ref_scope,
                                              feeds, grads)
        ref_peak = torch.cuda.max_memory_allocated()
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        param_diff, param_worst = max(
            ((scope.find_var(n) - ref_scope.find_var(n)).abs().max().item(),
             n) for n in params)
        rec = {"phase": "bert", "model": "bert-base", "seq": seq,
               "batch": batch, "amp": amp, "attn_impl": "fused",
               "optimizer": "adam", "lr": BERT_LR, "dropout": 0.0,
               "padded_share": float(1 - np.mean(
                   [f["input_mask"].mean() for f in feeds])),
               "steps": TRAIN_STEPS, "setup_s": setup_s, "step_ms": step_ms,
               **_bert_rates(cfg, batch, seq, step_ms, amp),
               "max_memory_allocated": peak, "launches": delta,
               "losses": losses, "einsum_losses": ref_losses,
               "einsum_step_ms": ref_ms,
               "einsum_max_memory_allocated": ref_peak,
               "loss_rel_diff": loss_rel,
               "loss_rtol": BERT_AMP_LOSS_RTOL if amp else LOSS_RTOL,
               "param_max_abs_diff": param_diff, "param_worst": param_worst,
               "param_tol": 2 * BERT_LR * TRAIN_STEPS + 1e-6}
        if not amp:
            # fused vs einsum, both exact
            grad_rtol, grad_ref = GRAD_RTOL, rg1
            exact = {n: g.clone() for n, g in g1.items()}
            fp32_losses = losses
        else:
            # both AMP programs against the exact gradients, and the AMP
            # losses against the fp32 run's, for the record
            grad_rtol, grad_ref = BERT_AMP_GRAD_RTOL, exact
            ratio, var, diff, tol = _grad_worst(rg1, exact, grad_rtol)
            rec.update({"einsum_grad_worst": {"var": var,
                                              "max_abs_diff": diff,
                                              "tol": tol, "ratio": ratio},
                        "loss_rel_diff_vs_fp32": [
                            abs(a - b) / abs(b)
                            for a, b in zip(losses, fp32_losses)]})
        ratio, var, diff, tol = _grad_worst(g1, grad_ref, grad_rtol)
        rec.update({"grad_rtol": grad_rtol, "grad_atol": GRAD_ATOL,
                    "grad_against": "einsum program" if not amp
                    else "fp32 fused run",
                    "grad_worst": {"var": var, "max_abs_diff": diff,
                                   "tol": tol, "ratio": ratio}})
        emit(rec)
        runs.append(rec)
        if not all(np.isfinite(losses + ref_losses)) \
                or max(loss_rel) > rec["loss_rtol"]:
            fail(f"bert amp={amp}: losses {losses} vs the einsum "
                 f"program's {ref_losses}")
        if ratio > 1.0:
            fail(f"bert amp={amp}: step-1 gradient {var} differs by {diff} "
                 f"> {tol} from the {rec['grad_against']}'s")
        if param_diff > rec["param_tol"]:
            fail(f"bert amp={amp}: parameter {param_worst} differs by "
                 f"{param_diff} after {TRAIN_STEPS} steps")
        del g1, rg1, scope, ref_scope, progs
        torch.cuda.empty_cache()
    del init, exact

    # bench.py's shape: BERT-base, s=128 b=128, einsum attention, AMP,
    # dropout 0.1; at s=128 no flash kernel runs
    seq, batch = 128, 128
    cfg = BertConfig()
    t0 = time.perf_counter()
    with ptt.unique_name_guard():
        main, startup, fetch = bert_pretrain_program(
            cfg, seq, learning_rate=BERT_LR, amp=True)
    startup.random_seed = main.random_seed = seed
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    feeds = [_bert_feed(rng, cfg, batch, seq, pad=False)
             for _ in range(TRAIN_STEPS)]
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for n in FLASH_KERNELS:
        getattr(fa, n).launches = 0
    losses, step_ms, _ = _bert_steps(exe, main, fetch, scope, feeds, [])
    delta = {n: getattr(fa, n).launches for n in FLASH_KERNELS}
    rec = {"phase": "bert", "model": "bert-base", "shape": "bench.py",
           "seq": seq, "batch": batch, "amp": True, "attn_impl": "einsum",
           "optimizer": "adam", "lr": BERT_LR, "dropout": cfg.dropout,
           "steps": TRAIN_STEPS, "setup_s": setup_s, "step_ms": step_ms,
           **_bert_rates(cfg, batch, seq, step_ms, True),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": delta, "losses": losses}
    emit(rec)
    runs.append(rec)
    if any(delta.values()):
        fail(f"bench.py's shape launched flash kernels: {delta}")
    if not all(np.isfinite(losses)):
        fail(f"bench.py's shape: non-finite losses {losses}")
    del scope
    torch.cuda.empty_cache()
    return {"runs": runs, "launches": launches,
            "shapes": {n: (16 * cfg.heads, 512)
                       for n in ("flash_small_fwd", "flash_small_bwd")}}


# ---------------------------------------------------------------------------
# phase 6: ResNet-50, bench_resnet50's train program, and its serving
# ---------------------------------------------------------------------------

RESNET_LR = 1e-3
RESNET_STEPS = 3
# The held fp32 run, card vs CPU from the same values and feeds. Step 1 is
# held: its loss to LOSS_RTOL, its gradients and its parameter updates
# (lr * g, the first Momentum step) per tensor to ||x - x_cpu|| <=
# RESNET_GRAD_L2 * ||x_cpu||, and the BN running statistics it leaves to
# |x - x_cpu| <= RESNET_STATE_TOL * max(1, max |x_cpu|). A ReLU net's
# gradient moves with the sign of each pre-activation within rounding of 0,
# and batch-norm at a small batch spreads each such flip over a whole
# channel: on the CPU, scaling the input by 1 + 1e-7 moves ResNet-50's own
# gradients by up to 0.027 relative L2 (0.27 of max |g| element-wise) at
# batch 2 and 4, and JAX's lie 0.029 from the port's
# (tests/test_torch_resnet.py); the card's own figure is measured here
# (sensitivity_l2: 0.028 on an H100 80GB HBM3 at 700 W). From those
# step-1 differences the two trajectories part: steps 2 and 3 are held to
# RESNET_LATER_LOSS_RTOL (measured 8.5e-4 and 2.0e-2 relative on that card,
# where the BN running variances after 3 steps stood 6.6 % apart).
RESNET_GRAD_L2 = 0.1
RESNET_STATE_TOL = 1e-4
RESNET_LATER_LOSS_RTOL = 0.1
# AMP from the fp32 run's parameters and feeds, against the fp32 run. On the
# CPU at batch 2-4 (port and JAX alike) the bf16 AMP gradients of ResNet-50
# at initialisation lie ~1.2 mean relative L2 from the fp32 ones below the
# last stage (the kinks above, at bf16's 2^-9), the fc gradients 0.7 %
# (bias) and 10 % (weights) away, every norm within 0.79-1.36 of fp32's, the
# loss 1.1-2.3 % away; on the H100 at batch 4, 0.5 %, 10.7 %, 0.90-1.29
# and 0.4 %. Held: the loss, each gradient's norm ratio, and the fc
# gradients.
RESNET_AMP_LOSS_RTOL = 5e-2
RESNET_AMP_NORM_RATIO = (0.5, 2.0)
RESNET_AMP_FC_L2 = {"fc_0.b_0": 5e-2, "fc_0.w_0": 0.25}
# Served logits, card vs CPU, the same saved model: within
# SERVE_LOGIT_RTOL * max |logit| (forward only, batch-norm on the running
# statistics: no kink enters a forward value by more than its rounding)
SERVE_LOGIT_RTOL = 1e-4
# bench_resnet50's FLOP convention: 4.089 GMAC an image forward, 2 FLOPs a
# MAC, x3 for forward and backward
RESNET_FLOPS_PER_IMAGE = 3 * 2 * 4.089e9


def _scope_from(values, device):
    import paddle_tpu_torch as ptt
    scope = ptt.Scope()
    for n, v in values.items():
        scope.set_var(n, v.to(device).clone())
    return scope


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _resnet_first_step(exe, main, loss, scope, feed, grads, after):
    """Step 1 with its gradients and the `after` vars (parameters, BN running
    statistics) as the step leaves them: (loss, grads, after, ms)."""
    import torch
    t = time.perf_counter()
    out = exe.run(main, feed=feed, fetch_list=[loss] + grads + after,
                  scope=scope, return_numpy=False)
    if exe.device.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    n = len(grads)
    return (float(out[0].item()), dict(zip(grads, out[1:1 + n])),
            dict(zip(after, out[1 + n:])), ms)


def _resnet_held(exe, cpu, main, startup, loss, seed, rng):
    """fp32 batch 4: RESNET_STEPS steps on the card and, from the same
    values and feeds, on the CPU. Returns (record, card scope, init, feeds,
    card step-1 grads, params)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.tools import bench_resnet50 as bench
    startup.random_seed = seed
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.find_var(n).detach().cpu().clone()
            for n in scope.var_names()
            if isinstance(scope.find_var(n), torch.Tensor)}
    params = [p.name for p in main.global_block.all_parameters()
              if p.trainable]
    grads = [p + "@GRAD" for p in params]
    stats = [v.name for v in main.list_vars() if v.persistable
             and (".mean_" in v.name or ".variance_" in v.name)]
    feeds = [bench.feed(rng, 4) for _ in range(RESNET_STEPS)]
    l1, g1, after, ms1 = _resnet_first_step(exe, main, loss, scope,
                                            feeds[0], grads, params + stats)
    later, later_ms, _ = _bert_steps(exe, main, {"loss": loss}, scope,
                                     feeds[1:], [])
    cscope = _scope_from(init, "cpu")
    t = time.perf_counter()
    cl1, cg1, cafter, _ = _resnet_first_step(cpu, main, loss, cscope,
                                             feeds[0], grads, params + stats)
    clater, _, _ = _bert_steps(cpu, main, {"loss": loss}, cscope, feeds[1:],
                               [])
    cpu_s = time.perf_counter() - t
    # the card's own sensitivity: step 1 again with the input scaled by
    # 1 + 1e-7
    pfeed = dict(feeds[0])
    pfeed["img"] = (pfeed["img"] * (1 + 1e-7)).astype(np.float32)
    _, pg1, _, _ = _resnet_first_step(exe, main, loss,
                                      _scope_from(init, exe.device), pfeed,
                                      grads, [])
    losses, closses = [l1] + later, [cl1] + clater
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, closses)]
    gl2 = {n: _rel_l2(g1[n].cpu(), cg1[n]) for n in grads}
    gmax = {n: ((g1[n].cpu() - cg1[n]).abs().max()
                / cg1[n].abs().max()).item() for n in grads}
    upd = {n: _rel_l2(after[n].cpu() - init[n], cafter[n] - init[n])
           for n in params}
    stat_err = max(((after[n].cpu() - cafter[n]).abs().max().item()
                    / max(1.0, cafter[n].abs().max().item()), n)
                   for n in stats)
    worst = max((v, n) for n, v in gl2.items())
    worst_upd = max((v, n) for n, v in upd.items())
    rec = {"phase": "resnet", "run": "held fp32", "model": "resnet50",
           "batch": 4, "hw": 224, "optimizer": "momentum", "lr": RESNET_LR,
           "steps": RESNET_STEPS, "step_ms": [ms1] + later_ms,
           "cpu_s": cpu_s, "losses": losses, "cpu_losses": closses,
           "loss_rel_diff": loss_rel,
           "loss_rtol": [LOSS_RTOL] + [RESNET_LATER_LOSS_RTOL] * len(later),
           "grad_worst_rel_l2": {"var": worst[1], "rel_l2": worst[0],
                                 "tol": RESNET_GRAD_L2},
           "grad_mean_rel_l2": float(np.mean(list(gl2.values()))),
           "grad_worst_max_over_max": max(gmax.values()),
           "sensitivity_l2": max(_rel_l2(pg1[n], g1[n]) for n in grads),
           "update_worst_rel_l2": {"var": worst_upd[1],
                                   "rel_l2": worst_upd[0],
                                   "tol": RESNET_GRAD_L2},
           "bn_stats_worst_after_step1": {"var": stat_err[1],
                                          "err": stat_err[0],
                                          "tol": RESNET_STATE_TOL},
           "tensors": {"grads": len(grads), "bn_stats": len(stats)}}
    emit(rec)
    if not all(np.isfinite(losses)) or loss_rel[0] > LOSS_RTOL or max(
            loss_rel[1:]) > RESNET_LATER_LOSS_RTOL:
        fail(f"resnet fp32: losses {losses} vs the CPU's {closses}")
    if worst[0] > RESNET_GRAD_L2 or worst_upd[0] > RESNET_GRAD_L2:
        fail(f"resnet fp32: step-1 gradient {worst[1]} or update "
             f"{worst_upd[1]} lies {max(worst[0], worst_upd[0])} relative "
             f"L2 from the CPU's")
    if stat_err[0] > RESNET_STATE_TOL:
        fail(f"resnet fp32: {stat_err[1]} differs from the CPU's by "
             f"{stat_err[0]} after step 1")
    return rec, scope, init, feeds, g1, params


def _resnet_amp(exe, init, feeds, g1, params, losses32):
    """AMP batch 4 from the fp32 run's parameters and feeds."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.tools import bench_resnet50 as bench
    main, startup, loss, _ = bench.build_program(amp=True, lr=RESNET_LR)
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    for n, v in init.items():
        if n in scope:
            scope.set_var(n, v.to(exe.device).clone())
    grads = [p + "@GRAD" for p in params]
    losses, step_ms, ag1 = _bert_steps(exe, main, {"loss": loss}, scope,
                                       feeds, grads)
    ratios = {n: (ag1[n].float().norm() / g1[n].float().norm()).item()
              for n in grads}
    gl2 = {n: _rel_l2(ag1[n], g1[n]) for n in grads}
    loss_rel = abs(losses[0] - losses32[0]) / abs(losses32[0])
    fc = {p: gl2[p + "@GRAD"] for p in RESNET_AMP_FC_L2}
    rec = {"phase": "resnet", "run": "held amp", "model": "resnet50",
           "batch": 4, "steps": RESNET_STEPS, "step_ms": step_ms,
           "losses": losses, "loss_rel_diff_vs_fp32_step1": loss_rel,
           "loss_rtol": RESNET_AMP_LOSS_RTOL,
           "grad_norm_ratio_range": [min(ratios.values()),
                                     max(ratios.values())],
           "norm_ratio_bounds": list(RESNET_AMP_NORM_RATIO),
           "fc_rel_l2": fc, "fc_rel_l2_tol": RESNET_AMP_FC_L2,
           "grad_mean_rel_l2": float(np.mean(list(gl2.values()))),
           "grad_worst_rel_l2": max(gl2.values()),
           "grads_finite": all(bool(g.float().isfinite().all())
                               for g in ag1.values())}
    emit(rec)
    lo, hi = RESNET_AMP_NORM_RATIO
    if not (rec["grads_finite"] and all(np.isfinite(losses))):
        fail(f"resnet amp: non-finite losses or gradients: {rec}")
    if loss_rel > RESNET_AMP_LOSS_RTOL or not all(
            lo <= r <= hi for r in ratios.values()) or any(
            fc[p] > RESNET_AMP_FC_L2[p] for p in fc):
        fail(f"resnet amp: outside its bounds against the fp32 run: {rec}")
    return rec


def _resnet_serve(exe, main, logits, scope, rng):
    """clone(for_test=True) of the trained program, save_inference_model,
    a Predictor at batch 8 on the card and one on the CPU from the same
    directory."""
    import numpy as np
    import paddle_tpu_torch as ptt
    test_prog = main.clone(for_test=True)
    modes = {op.attrs.get("is_test") for op in test_prog.global_block.ops
             if op.type == "batch_norm"}
    d = os.path.join(WORK_DIR, "resnet50")
    ptt.io.save_inference_model(d, ["img"], [logits], exe,
                                main_program=test_prog, scope=scope)
    card = ptt.inference.create_predictor(ptt.inference.Config(d))
    cfg = ptt.inference.Config(d)
    cfg.disable_gpu()
    host = ptt.inference.create_predictor(cfg)
    imgs = rng.rand(8, 3, 224, 224).astype(np.float32)
    card.run({"img": imgs})                            # warm-up
    lat = []
    for _ in range(3):
        t = time.perf_counter()
        out, = card.run({"img": imgs})
        lat.append((time.perf_counter() - t) * 1e3)
    ref, = host.run({"img": imgs})
    diff = float(np.abs(out - ref).max())
    tol = SERVE_LOGIT_RTOL * float(np.abs(ref).max())
    rec = {"phase": "resnet", "run": "served", "batch": 8,
           "batch_norm_is_test": sorted(modes), "device": str(card.device),
           "request_ms": lat, "median_request_ms": sorted(lat)[1],
           "max_abs_logit_diff_vs_cpu": diff, "tol": tol,
           "logits_shape": list(out.shape)}
    emit(rec)
    if modes != {True} or out.shape != (8, 1000) or card.device.type != \
            "cuda" or not np.isfinite(out).all() or diff > tol:
        fail(f"resnet served: {rec}")
    shutil.rmtree(d, ignore_errors=True)
    return rec


def _resnet_timed(exe, seed, rng):
    """bench_resnet50's shape: batch 128, NCHW, AMP, Momentum(0.1, 0.9); one
    warm-up step, then 5 timed steps, each up to a synchronise."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.tools import bench_resnet50 as bench
    main, startup, loss, _ = bench.build_program(amp=True, lr=0.1)
    startup.random_seed = main.random_seed = seed
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    feed = bench.feed(rng, 128)
    _bert_steps(exe, main, {"loss": loss}, scope, [feed], [])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, _ = _bert_steps(exe, main, {"loss": loss}, scope,
                                     [feed] * 5, [])
    med = sorted(step_ms)[len(step_ms) // 2]
    flops = RESNET_FLOPS_PER_IMAGE * 128
    rec = {"phase": "resnet", "run": "timed", "shape": "bench_resnet50",
           "batch": 128, "fmt": "NCHW", "amp": True,
           "optimizer": "momentum(0.1, 0.9)", "ops": len(main.global_block
                                                          .ops),
           "step_ms": step_ms, "median_step_ms": med,
           "img_per_s": 128 / (med / 1e3), "flops_per_step": flops,
           "mfu_vs_bf16_peak": flops / (med / 1e3) / PEAK_BF16_FLOPS,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "losses": losses}
    emit(rec)
    if not all(np.isfinite(losses)):
        fail(f"resnet timed: non-finite losses {losses}")
    return rec


def phase_resnet(seed):
    """ResNet-50 at full width (224x224, 1000 classes) through Executor.run
    and the inference Predictor on CUDAPlace(0); no hand-written kernel
    runs on this path (its convs go to cuDNN), which the counts show."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.tools import bench_resnet50 as bench
    exe = ptt.Executor(ptt.CUDAPlace(0))
    cpu = ptt.Executor(ptt.CPUPlace())
    rng = np.random.RandomState(seed)
    main, startup, loss, logits = bench.build_program(amp=False,
                                                      lr=RESNET_LR)
    zero_counts(KERNELS)
    # ---- the main path: counts zeroed just before, read just after ----
    held, scope, init, feeds, g1, params = _resnet_held(
        exe, cpu, main, startup, loss, seed, rng)
    amp = _resnet_amp(exe, init, feeds, g1, params, held["losses"])
    served = _resnet_serve(exe, main, logits, scope, rng)
    del scope, g1, init
    torch.cuda.empty_cache()
    timed = _resnet_timed(exe, seed, rng)
    launches = read_counts(KERNELS)
    # -------------------------------------------------------------------
    emit({"phase": "resnet_launches", "launches": launches,
          "note": "no hand-written kernel runs on the ResNet-50 path"})
    if any(launches.values()):
        fail(f"the ResNet-50 path launched hand kernels: {launches}")
    torch.cuda.empty_cache()
    return {"held": held, "amp": amp, "served": served, "timed": timed}


# ---------------------------------------------------------------------------
# phase 7: the spikes: residual + LayerNorm, conv + BN, the head-slice repro
# ---------------------------------------------------------------------------

def phase_spike(seed):
    """The residual + LayerNorm spike's table, the conv + BN spike's table
    and the head-slice repro, each on its own entry point."""
    from paddle_tpu_torch.tools import mosaic_repro_headslice as mrh
    from paddle_tpu_torch.tools import spike_conv_bn as scb
    from paddle_tpu_torch.tools import spike_residual_ln as srl
    names = LN_KERNELS + CONV_BN_KERNELS + ["headslice_gram"]
    zero_counts(names)
    # ---- the spikes' paths: counts zeroed just before, read just after ----
    rows = srl.spike_table(seed, emit)
    cbn_rows = scb.spike_table(seed, emit)
    ok, err = mrh.run(seed)
    launches = read_counts(names)
    # -----------------------------------------------------------------------
    if not ok:
        fail(f"the head-slice repro's kernel differs by {err}")
    for n, c in launches.items():
        if c == 0:
            fail(f"kernel {n} was not launched on the spike's path")
    emit({"phase": "spike_launches", "launches": launches})
    return {"rows": rows, "conv_bn_rows": cbn_rows, "headslice_err": err,
            "launches": launches}


# ---------------------------------------------------------------------------
# phase 8: times at the main-path shapes
# ---------------------------------------------------------------------------

def _pairs(sq, sk, causal):
    """(query, key) pairs the mask keeps; causal is top-left aligned (row
    r sees keys 0..r)."""
    return sum(min(r + 1, sk) for r in range(sq)) if causal else sq * sk


def _peak_flops(elem):
    """The card's peak rate for operands of `elem` bytes: bf16 (2) on the
    tensor cores, fp32 (4) outside them, as TF32 is off."""
    return PEAK_BF16_FLOPS if elem == 2 else PEAK_FP32_FLOPS


def _bound(name, bn, sq, sk, d, causal, elem, bias=False):
    """Least time (ms) for a kernel's work: its FLOPs over the kept pairs
    (4 per pair and head-dim column forward: S and P.V; 8 for dkv: S, dP,
    dV, dK; 6 for dq: S, dP, dQ; 10 for the single pass: S, dP, dV, dK, dQ)
    at the peak of the operands' type, against its inputs read once and
    outputs written once (with a bias,
    its f32 (b*n, sk) read, and the bias grad written by the backward
    kernels that own keys)."""
    flop_mult, q_io, k_io = {
        # (FLOPs per pair and column, (b*n, sq, d) tensors moved,
        #  (b*n, sk, d) tensors moved); every kernel also reads or writes
        #  lse (and the backward kernels delta), f32 (b*n, sq)
        "flash_fwd": (4, 2, 2), "flash_small_fwd": (4, 2, 2),
        "flash_bwd_dkv": (8, 2, 4), "flash_bwd_dq": (6, 3, 2),
        "flash_small_bwd": (10, 3, 4)}[name]
    rows = 1 if name.endswith("fwd") else 2
    flops = float(flop_mult) * bn * _pairs(sq, sk, causal) * d
    nbytes = (q_io * bn * sq * d + k_io * bn * sk * d) * elem \
        + 4 * rows * bn * sq
    if bias:
        nbytes += 4 * bn * sk * (1 if name in ("flash_fwd", "flash_small_fwd",
                                               "flash_bwd_dq") else 2)
    t_ops, t_bytes = flops / _peak_flops(elem), nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops, nbytes


def _sdpa_bwd_ms(q, k, v, do, n, causal=True, bias=None):
    """The backward alone of F.scaled_dot_product_attention on the same
    (b*n, s, d) inputs (with a per-key bias as its additive mask), through
    torch.autograd.grad: a yardstick only, the port never calls it. It
    computes dQ, dK and dV together."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.tools.profile_gpt import time_ms
    bn, s, d = q.shape
    q4, k4, v4 = (t.detach().view(bn // n, n, s, d).requires_grad_()
                  for t in (q, k, v))
    mask = None if bias is None else _sdpa_mask(bias, n).to(q.dtype)
    out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                         is_causal=causal)
    do4 = do.view(bn // n, n, s, d)
    return time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do4,
                                               retain_graph=True))


def _sdpa_mask(bias, n):
    """(b*n, sk) per-key bias -> (b, 1, 1, sk), SDPA's additive mask."""
    bn, sk = bias.shape
    return bias.view(bn // n, n, sk)[:, :1, None, :]


def _flash_rows(serve, train, bert, seed):
    """The five flash kernels at their GPT main-path shapes (fp32, causal),
    then the two single-pass ones at BERT's (bf16, per-key bias)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.tools.profile_gpt import time_ms
    n, d = serve["heads"], serve["head_dim"]
    sm = d ** -0.5
    rows = []
    cases = [(name, train["shapes"][name], torch.float32, True, False)
             for name in FLASH_KERNELS]
    cases += [(name, bert["shapes"][name], torch.bfloat16, False, True)
              for name in ("flash_small_fwd", "flash_small_bwd")]
    for name, (bn, s), dtype, causal, with_bias in cases:
        kernel = getattr(fa, name)
        plain = getattr(fa, name + "_plain")
        b = bn // n
        if KERNELS[name]["serve"]:
            q, k, v, bias = _inputs(bn, s, s, d, dtype, with_bias, seed)
            ok, err_o, err_l, _ = _compare(kernel, plain, q, k, v, bias,
                                           causal, sm)
            err = max(err_o, err_l)
            args = (q, k, v, bias)
            q4, k4, v4 = (t.view(b, n, s, d) for t in (q, k, v))
            mask = None if bias is None else _sdpa_mask(bias, n).to(dtype)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, is_causal=causal))
        else:
            args = _bwd_inputs(bn, s, s, d, dtype, with_bias, causal, seed)
            ok, err, _ = _compare_bwd(name, args, causal, sm)
            lib_ms = _sdpa_bwd_ms(args[0], args[1], args[2], args[4], n,
                                  causal, args[3])
        if not ok:
            fail(f"{name} disagrees with its plain version at the main-path "
                 "shape")
        ms = time_ms(lambda: kernel(*args, causal, sm))
        plain_ms = time_ms(lambda: plain(*args, causal, sm), iters=5)
        bound_ms, bound_by, flops, nbytes = _bound(
            name, bn, s, s, d, causal, torch.finfo(dtype).bits // 8,
            with_bias)
        launches = train["launches"][name] + serve["launches"].get(name, 0) \
            + bert["launches"][name]
        emit({"phase": "time", "kernel": name, "bn": bn, "sq": s, "sk": s,
              "d": d, "dtype": str(dtype).split(".")[-1], "causal": causal,
              "bias": with_bias, "flops": flops, "bytes": nbytes, "ms": ms,
              "plain_ms": plain_ms, "library_ms": lib_ms,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "launches_serve": serve["launches"].get(name, 0),
              "launches_train": train["launches"][name],
              "launches_bert": bert["launches"][name],
              "tflops_per_s": flops / (ms * 1e-3) / 1e12})
        if with_bias:
            continue   # the kernels line keeps the GPT shapes' rows
        rows.append({"name": name, "route": "cuda",
                     "source": KERNELS[name]["source"],
                     "replaces": KERNELS[name]["replaces"],
                     "launches": launches, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms})
    return rows


# FLOPs a value of the residual + LayerNorm kernels: forward add, sum,
# subtract, square-and-sum, two multiplies and an add; backward add,
# subtract, multiply, g * scale, two products summed, the ds expression
# (4) and the two column sums
LN_FLOPS_PER_VALUE = {"residual_ln_fwd": 8, "residual_ln_bwd": 13}


def _ln_rows(spike, seed):
    """The residual + LayerNorm kernels at BERT-base's bench shape, (16384,
    768) bf16; library yardsticks F.layer_norm(x + r) for the forward and
    aten's native_layer_norm_backward (from its own saved mean, rstd) for
    the backward."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.tools import spike_residual_ln as srl
    from paddle_tpu_torch.tools.profile_gpt import time_ms
    m, h = srl.SHAPES[0]
    x, r, sc, b = srl.spike_inputs(m, h, torch.bfloat16, seed)
    g = torch.randn(x.shape, device=x.device).to(x.dtype)
    sc16, b16 = sc.to(x.dtype), b.to(x.dtype)
    _, mu, rstd = srl.residual_ln_fwd_plain(x, r, sc, b)
    s_ = x + r
    _, lmu, lrstd = torch.ops.aten.native_layer_norm(s_, [h], sc16, b16,
                                                     srl.EPS)
    alone = dict(zip(LN_KERNELS, srl.prepared_launches(x, r, sc, b, g)))
    calls = {
        "residual_ln_fwd": (
            lambda: srl.residual_ln_fwd(x, r, sc, b),
            lambda: srl.residual_ln_fwd_plain(x, r, sc, b),
            lambda: F.layer_norm(x + r, (h,), sc16, b16, srl.EPS)),
        "residual_ln_bwd": (
            lambda: srl.residual_ln_bwd(x, r, sc, mu, rstd, g),
            lambda: srl.residual_ln_bwd_plain(x, r, sc, mu, rstd, g),
            lambda: torch.ops.aten.native_layer_norm_backward(
                g, s_, [h], lmu, lrstd, sc16, b16, [True, True, True])),
    }
    fb, bb = srl.bound_bytes(m, h, x.element_size())
    rows = []
    for name in LN_KERNELS:
        kern, plain, lib = calls[name]
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max((a.float() - w.float()).abs().max().item()
                  for a, w in zip(got, want))
        # the kernel alone (prepared launches); through the wrapper, its
        # checks and allocations take longer than the kernel at this shape
        ms = time_ms(alone[name])
        wrapper_ms = time_ms(kern)
        plain_ms = time_ms(plain, iters=5)
        lib_ms = time_ms(lib)
        nbytes = fb if name == "residual_ln_fwd" else bb
        flops = LN_FLOPS_PER_VALUE[name] * m * h
        t_ops = flops / _peak_flops(x.element_size())
        t_bytes = nbytes / PEAK_BYTES
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        emit({"phase": "time", "kernel": name, "M": m, "H": h,
              "dtype": "bfloat16", "flops": flops, "bytes": nbytes,
              "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
              "library_ms": lib_ms, "bound_ms": bound_ms,
              "bound_by": bound_by,
              "launches_spike": spike["launches"][name],
              "bytes_per_s": nbytes / (ms * 1e-3)})
        rows.append({"name": name, "route": "cuda",
                     "source": KERNELS[name]["source"],
                     "replaces": KERNELS[name]["replaces"],
                     "launches": spike["launches"][name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms})
    return rows


def _alone_row(name, alone, kern, plain, lib, bound, launches, err, extra,
               device=False):
    """A times record and a kernels-line row for a spike kernel: the kernel
    alone (prepared launches through the wrapper's `_run`), through its
    wrapper, its plain version and the library yardstick. With `device`,
    the kernel's time is its device time in a profiler trace, the launch
    path's host work being longer than the kernel (`event_ms` keeps the
    CUDA-event time of back-to-back launches)."""
    from paddle_tpu_torch.tools.profile_gpt import device_time_ms, time_ms
    ms = time_ms(alone)
    bound_ms, bound_by, flops, nbytes = bound
    extra = dict(extra)
    if device:
        extra["event_ms"], ms = ms, device_time_ms(alone)
    rec = {"phase": "time", "kernel": name, **extra, "flops": flops,
           "bytes": nbytes, "ms": ms, "wrapper_ms": time_ms(kern),
           "plain_ms": time_ms(plain, iters=5),
           "library_ms": time_ms(lib), "bound_ms": bound_ms,
           "bound_by": bound_by, "launches_spike": launches,
           "bytes_per_s": nbytes / (ms * 1e-3)}
    emit(rec)
    return {"name": name, "route": "cuda", "source": KERNELS[name]["source"],
            "replaces": KERNELS[name]["replaces"], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": rec["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": rec["library_ms"]}


def _conv_bn_rows(spike, seed):
    """conv_bn_stats at every spike shape and bn_apply_relu on its output;
    the kernels line keeps conv_bn_stats at (401408, 64, 64) and
    bn_apply_relu at (401408, 256). Library yardsticks (compositions, no
    single call computes either): torch.matmul then the two f32 column
    reductions; torch.addcmul then relu."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.tools import spike_conv_bn as scb
    rows = {}
    for m, k, c in scb.SHAPES:
        x, w, gamma, beta = scb.spike_inputs(m, k, c, seed)
        alone = scb.prepared_launches(x, w, gamma, beta)
        y, s_, q = scb.fused_conv_bn_stats(x, w)
        sc, sh = scb.bn_scale_shift(s_, q, m, gamma, beta)
        ref = scb.fused_conv_bn_stats_plain(x, w)
        err6 = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip((y, s_, q), ref))
        out = scb.bn_apply_relu(y, s_, q, gamma, beta)
        err7 = (out.float() - scb.bn_apply_relu_plain(
            y, s_, q, gamma, beta).float()).abs().max().item()

        def lib6():
            y32 = torch.matmul(x, w).float()
            return y32.sum(0), (y32 * y32).sum(0)

        r6 = _alone_row(
            "conv_bn_stats", alone[0],
            lambda: scb.fused_conv_bn_stats(x, w),
            lambda: scb.fused_conv_bn_stats_plain(x, w), lib6,
            scb.stats_bound(m, k, c), spike["launches"]["conv_bn_stats"],
            err6, {"M": m, "K": k, "C": c, "dtype": "bfloat16"})
        r7 = _alone_row(
            "bn_apply_relu", alone[1],
            lambda: scb.bn_apply_relu(y, s_, q, gamma, beta),
            lambda: scb.bn_apply_relu_plain(y, s_, q, gamma, beta),
            lambda: F.relu(torch.addcmul(sh, y, sc)).to(y.dtype),
            scb.apply_bound(m, c), spike["launches"]["bn_apply_relu"],
            err7, {"M": m, "C": c, "dtype": "bfloat16"})
        rows.setdefault("conv_bn_stats", r6)
        if (m, c) == (401408, 256):
            rows["bn_apply_relu"] = r7
        del x, w, y, out, ref
    return [rows["conv_bn_stats"], rows["bn_apply_relu"]]


def _gram_row(spike, seed):
    """headslice_gram at the repro's shape, its time the device time of the
    kernel (a launch costs the host more); library yardstick torch.bmm on
    the strided slice and its transpose."""
    import torch
    from paddle_tpu_torch.tools import mosaic_repro_headslice as mrh
    b, s_, n, d = mrh.SHAPE
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.rand(mrh.SHAPE, generator=g, device="cuda")
    xs = x[:, :, -1]
    err = (mrh.headslice_gram(x) - mrh.headslice_gram_plain(x)).abs().max() \
        .item()
    return _alone_row(
        "headslice_gram", mrh.prepared_launch(x),
        lambda: mrh.headslice_gram(x), lambda: mrh.headslice_gram_plain(x),
        lambda: torch.bmm(xs, xs.transpose(1, 2)), mrh.gram_bound(b, s_, d),
        spike["launches"]["headslice_gram"], err,
        {"b": b, "s": s_, "n": n, "d": d, "dtype": "float32"}, device=True)


def phase_times(serve, train, bert, spike, seed):
    return (_flash_rows(serve, train, bert, seed) + _ln_rows(spike, seed)
            + _conv_bn_rows(spike, seed) + [_gram_row(spike, seed)])


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
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul.allow_bf16_reduced_precision_reduction":
              torch.backends.cuda.matmul
              .allow_bf16_reduced_precision_reduction})
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    try:
        build = phase_build()
        kernels = phase_kernels(args.seed)
        serve = phase_serve(args.seed)
        train = phase_train(args.seed)
        bert = phase_bert(args.seed)
        resnet = phase_resnet(args.seed)
        spike = phase_spike(args.seed)
        rows = phase_times(serve, train, bert, spike, args.seed)
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "seed": args.seed,
                   "wall_s": time.perf_counter() - t0, "build": build,
                   "kernel_cases": kernels, "serve": serve["summary"],
                   "train": train["summaries"], "bert": bert["runs"],
                   "resnet": resnet, "spike": spike["rows"],
                   "spike_conv_bn": spike["conv_bn_rows"],
                   "requests": serve["requests"], "kernels": rows}, f,
                  indent=1)
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
