"""GPT inference slice of the PyTorch port against the JAX package, on the
CPU: the same tiny GPT (vocab 256, hidden 64, 2 layers, 4 heads, dropout
0.1 under is_test) through Program -> Executor -> fused_attention in both.

  * a model directory the JAX package saves loads into the port's
    Predictor (and the other way round), logits within 1e-4;
  * with attn_impl="flash" the JAX package runs its Pallas kernels in
    interpret mode and the port runs its kernels' plain versions;
  * the port's own DSL builds the same program (ops, slots, attrs, vars)
    and, with the JAX parameters carried over, the same logits;
  * places are real, and the port never imports jax or paddle_tpu.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models.gpt import GPTConfig, gpt_lm_program
from paddle_tpu_torch.models import gpt as tgpt
from torch_port_common import one_torch_thread  # noqa: F401


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4   # logits: f32 end to end, summation order differs


def _cfg(mod, impl):
    return mod(vocab_size=256, hidden=64, layers=2, heads=4, max_pos=640,
               dropout=0.1, attn_impl=impl)


def _tokens(seq, batch=2, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (batch, seq)) \
        .astype("int64")


def _jax_build(seq, impl):
    """JAX-side program, initialized scope and its parameters as numpy."""
    with pt.unique_name_guard():
        main, startup, fetches = gpt_lm_program(
            _cfg(GPTConfig, impl), seq, is_test=True)
    scope = pt.Scope()
    exe = pt.Executor()
    exe.run(startup, scope=scope)
    params = {v.name: np.asarray(scope.find_var(v.name))
              for v in main.list_vars() if v.persistable
              and scope.find_var(v.name) is not None}
    return main, scope, exe, fetches, params


def _jax_logits(main, scope, exe, fetches, toks):
    out, = exe.run(main, feed={"tokens": toks},
                   fetch_list=[fetches["logits"]], scope=scope)
    return np.asarray(out)


def _cpu_predictor(model_dir):
    cfg = ptt.inference.Config(model_dir)
    cfg.disable_gpu()
    return ptt.inference.create_predictor(cfg)


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """{(seq, impl): (model_dir, params, jax predictor logits)}."""
    out = {}
    for seq, impl in ((256, "fused"), (640, "fused"), (256, "flash"),
                      (640, "flash")):
        main, scope, exe, fetches, params = _jax_build(seq, impl)
        d = str(tmp_path_factory.mktemp(f"gpt_{seq}_{impl}"))
        pt.io.save_inference_model(d, ["tokens"], [fetches["logits"]], exe,
                                   main_program=main, scope=scope)
        pred = pt.inference.create_predictor(pt.inference.Config(d))
        logits = np.asarray(pred.run({"tokens": _tokens(seq)})[0])
        out[(seq, impl)] = (d, params, logits)
    return out


@pytest.mark.parametrize("impl", ["fused", "flash"])
@pytest.mark.parametrize("seq", [256, 640])
def test_predictor_loads_jax_saved_model(jax_saved, seq, impl):
    d, _, ref = jax_saved[(seq, impl)]
    pred = _cpu_predictor(d)
    assert pred.get_input_names() == ["tokens"]
    assert str(pred.device) == "cpu"
    logits, = pred.run({"tokens": _tokens(seq)})
    assert logits.shape == (2, seq, 256)
    np.testing.assert_allclose(logits, ref, atol=TOL, rtol=TOL)


def _program_dict(prog):
    """Serialized program, with two declared-metadata differences evened
    out: the Lse vars' shapes are dropped (on the meta device
    fused_attention takes the plain path, so the port declares the dummy
    (1, 1) where a flash build in JAX declares the kernel's lane-padded
    lse), and int64 reads as int32 (JAX without x64 infers int64 results
    as int32; the port keeps torch's int64)."""
    d = json.loads(prog.serialize_to_string())
    lse = {n for b in d["blocks"] for op in b["ops"]
           if op["type"] == "fused_attention" for n in op["outputs"]["Lse"]}
    for b in d["blocks"]:
        for v in b["vars"]:
            if v["name"] in lse:
                v["shape"] = None
            if v["dtype"] == "int64":
                v["dtype"] = "int32"
    return d


@pytest.mark.parametrize("impl", ["fused", "flash"])
@pytest.mark.parametrize("seq", [256, 640])
def test_port_dsl_matches_jax_program_and_logits(jax_saved, seq, impl):
    _, params, ref = jax_saved[(seq, impl)]
    jmain = _jax_build(seq, impl)[0]
    with ptt.unique_name_guard():
        tmain, tstartup, tfetch = tgpt.gpt_lm_program(
            _cfg(tgpt.GPTConfig, impl), seq, is_test=True)
    assert _program_dict(tmain) == _program_dict(jmain)

    scope = ptt.Scope()
    ptt.io.set_params_from_numpy(scope, params, "cpu")
    exe = ptt.Executor(ptt.CPUPlace())
    logits, = exe.run(tmain, feed={"tokens": _tokens(seq)},
                      fetch_list=[tfetch["logits"]], scope=scope)
    np.testing.assert_allclose(logits, ref, atol=TOL, rtol=TOL)


def test_port_startup_and_save_load_in_jax(tmp_path):
    """The port initializes, saves; the JAX package loads the directory
    and computes the same logits."""
    seq = 256
    with ptt.unique_name_guard():
        tmain, tstartup, tfetch = tgpt.gpt_lm_program(
            _cfg(tgpt.GPTConfig, "fused"), seq, is_test=True)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(tstartup, scope=scope)
    w = scope.find_var("gpt/l0/q.w")
    assert tuple(w.shape) == (64, 64) and str(w.device) == "cpu"
    assert 0.015 < float(w.std()) < 0.025          # Normal(0, 0.02)
    d = str(tmp_path / "port_saved")
    ptt.io.save_inference_model(d, ["tokens"], [tfetch["logits"]], exe,
                                main_program=tmain, scope=scope)
    ours, = _cpu_predictor(d).run({"tokens": _tokens(seq, seed=3)})
    jpred = pt.inference.create_predictor(pt.inference.Config(d))
    theirs = np.asarray(jpred.run({"tokens": _tokens(seq, seed=3)})[0])
    np.testing.assert_allclose(ours, theirs, atol=TOL, rtol=TOL)


def test_places_are_real():
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour")
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        ptt.Executor()
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        ptt.Executor(ptt.CUDAPlace(0))
    with pytest.raises(TypeError):
        ptt.Executor("cpu")
    cfg = ptt.inference.Config("unused")
    assert cfg.use_gpu()
    assert repr(cfg.place()) == "CUDAPlace(0)"
    cfg.disable_gpu()
    assert repr(cfg.place()) == "CPUPlace()"
    assert ptt.Executor(ptt.CPUPlace()).device.type == "cpu"


def test_run_before_startup_and_bad_feed_raise():
    with ptt.unique_name_guard():
        main, startup, f = tgpt.gpt_lm_program(
            _cfg(tgpt.GPTConfig, "fused"), 256, is_test=True)
    exe = ptt.Executor(ptt.CPUPlace())
    with pytest.raises(RuntimeError, match="run the startup program first"):
        exe.run(main, feed={"tokens": _tokens(256)},
                fetch_list=[f["logits"]], scope=ptt.Scope())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="shape"):
        exe.run(main, feed={"tokens": _tokens(128)},
                fetch_list=[f["logits"]], scope=scope)
    with pytest.raises(ValueError, match="not fed"):
        exe.run(main, feed={}, fetch_list=[f["logits"]], scope=scope)


def test_port_imports_neither_jax_nor_paddle_tpu(jax_saved):
    d = jax_saved[(256, "fused")][0]
    code = (
        "import sys, numpy as np\n"
        "import paddle_tpu_torch as ptt\n"
        f"cfg = ptt.inference.Config({d!r}); cfg.disable_gpu()\n"
        "pred = ptt.inference.create_predictor(cfg)\n"
        "toks = np.zeros((1, 256), 'int64')\n"
        "out, = pred.run({'tokens': toks})\n"
        "assert out.shape == (1, 256, 256)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'paddle_tpu'\n"
        "             or m.startswith('paddle_tpu.'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
