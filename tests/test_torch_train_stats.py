"""The port's training telemetry plane: the cases of tests/test_train_stats.py
that involve the executor, on the port's Executor on the CPU.

(a) per-step records: finite loss, a grad-norm within 1e-5 relative of a
NumPy recomputation from the fetched gradients, monotonic step ids, the
JSONL file, compile accounting on the compiling step (torch's FLOP count;
peak_bytes is the card's and None on the CPU); (b) the sentinel policies
on an injected NaN — skip_step leaves params and Adam state bit-identical,
halt raises and preserves them, warn counts and lets the NaN through —
with the flag in the same fetch list as the user's outputs; (c) the
global-norm clip: the surfaced norm is the pre-clip raw norm and the
clipped grad is g * clip / max(norm, clip); (d) /trainz; (e) with no
logger the plane is a no-op: no telemetry ops, no extra fetches, no train
registry series; the tap prunes from clone(for_test=True).

The program is a small classifier (4 -> 8 relu -> 3, softmax
cross-entropy, Adam); a NaN in the input poisons the loss and grads.
"""

import http.client
import json
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import train_stats as ts
from torch_port_common import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_plane():
    ts.uninstall_step_logger()
    obs.get_registry().reset()
    yield
    ts.uninstall_step_logger()
    obs.get_registry().reset()
    obs.stop_debug_server()


RNG = np.random.RandomState(0)
X0 = RNG.randn(8, 4).astype("f")
Y0 = RNG.randint(0, 3, (8, 1)).astype("int64")
XNAN = X0.copy()
XNAN[0, 0] = np.nan
FEED = {"x": X0, "y": Y0}
NAN_FEED = {"x": XNAN, "y": Y0}


def build_program(grad_clip=None, lr=0.01):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name_guard(), pt.program_guard(main, startup):
        x = pt.layers.data("x", [4])
        y = pt.layers.data("y", [1], dtype="int64")
        h = pt.layers.fc(x, 8, act="relu")
        logits = pt.layers.fc(h, 3)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits, y))
        pt.optimizer.Adam(lr, grad_clip=grad_clip).minimize(loss)
    return main, startup, loss


def _exe():
    return pt.Executor(pt.CPUPlace())


def _np_norm(grads):
    return np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in grads))


def test_step_records_jsonl_and_grad_norm_truth(tmp_path):
    logger = ts.install_step_logger(
        ts.StepLogger(log_dir=str(tmp_path), run_name="run"))
    main, startup, loss = build_program()
    gnames = [p.name + "@GRAD" for p in main.all_parameters()]
    exe = _exe()
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        outs = [exe.run(main, feed=FEED, fetch_list=[loss] + gnames)
                for _ in range(4)]
    recs = logger.recent()
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    for r, out in zip(recs, outs):
        assert r["finite"] and not r["skipped"] and np.isfinite(r["loss"])
        assert r["step_time_s"] > 0 and r["examples_per_s"] > 0
        assert r["lr"] == pytest.approx(0.01, rel=1e-5)
        assert r["grad_norm"] == pytest.approx(_np_norm(out[1:]), rel=1e-5)
    path = os.path.join(str(tmp_path), "run.jsonl")
    steps = [json.loads(line) for line in open(path) if line.strip()]
    steps = [s for s in steps if s["kind"] == "step"]
    assert [s["step"] for s in steps] == [1, 2, 3, 4]
    assert steps[0]["compiled"] and not steps[1]["compiled"]
    assert steps[0]["compile"]["flops"] > 0          # torch's FLOP count
    assert steps[0]["compile"]["peak_bytes"] is None  # no card here
    assert recs[-1]["scope_bytes"] > 0


def _snapshot(main, scope):
    names = [p.name for p in main.all_parameters()]
    names += [n for n in scope.var_names() if "moment" in n or "beta" in n]
    return {n: scope.get_numpy(n) for n in names}


def test_sentinel_skip_step_leaves_state_bit_identical():
    logger = ts.install_step_logger(ts.StepLogger(policy="skip_step"))
    main, startup, loss = build_program()
    assert main._train_telemetry["policy"] == "skip_step"
    exe = _exe()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=FEED, fetch_list=[loss], scope=scope)
    pre = _snapshot(main, scope)
    assert len(pre) >= 12  # 4 params + their adam moments and beta pows
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        lv, = exe.run(main, feed=NAN_FEED, fetch_list=[loss], scope=scope)
    assert not np.isfinite(lv).all()
    for n, v in pre.items():
        np.testing.assert_array_equal(scope.get_numpy(n), v, err_msg=n)
    exe.run(main, feed=FEED, fetch_list=[loss], scope=scope)
    assert any(not np.array_equal(scope.get_numpy(n), v)
               for n, v in pre.items())
    # one compiled step for the three runs of `main` (startup the other),
    # the flag in the same fetch list as the user's loss
    assert exe.compile_count == 2
    snap = obs.get_registry().snapshot()
    assert snap["executor_runs_total"]["series"][0]["value"] == 4.0
    assert main._train_telemetry["flag"] in exe.last_fetch_names
    assert len(exe.last_fetch_names) == 4  # loss+gnorm+flag+lr
    rec = logger.recent()[1]
    assert rec["skipped"] and not rec["finite"]
    assert logger.nan_steps == 1
    assert snap["nan_steps_total"]["series"] == [
        {"labels": {"policy": "skip_step"}, "value": 1.0}]


def test_sentinel_halt_raises_and_preserves_params():
    ts.install_step_logger(ts.StepLogger(policy="halt"))
    main, startup, loss = build_program()
    exe = _exe()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=FEED, fetch_list=[loss], scope=scope)
    pre = _snapshot(main, scope)
    with pytest.raises(FloatingPointError, match="halt"):
        exe.run(main, feed=NAN_FEED, fetch_list=[loss], scope=scope)
    for n, v in pre.items():
        np.testing.assert_array_equal(scope.get_numpy(n), v, err_msg=n)


def test_sentinel_warn_counts_and_does_not_gate():
    logger = ts.install_step_logger(ts.StepLogger(policy="warn"))
    main, startup, loss = build_program()
    exe = _exe()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=FEED, fetch_list=[loss], scope=scope)
    with pytest.warns(RuntimeWarning, match="non-finite"):
        exe.run(main, feed=NAN_FEED, fetch_list=[loss], scope=scope)
    w = scope.get_numpy(main.all_parameters()[0].name)
    assert not np.isfinite(w).all()
    assert logger.nan_steps == 1
    rec = logger.recent()[-1]
    assert not rec["finite"] and not rec["skipped"]
    assert obs.get_registry().snapshot()["nan_steps_total"]["series"] == [
        {"labels": {"policy": "warn"}, "value": 1.0}]


def test_clip_global_norm_surfaced_matches_numpy_reference():
    logger = ts.install_step_logger(ts.StepLogger())
    clip_norm = 0.05
    main, startup, loss = build_program(
        grad_clip=pt.clip.GradientClipByGlobalNorm(clip_norm))
    assert main._global_norm_var == main._train_telemetry["grad_norm"]
    gnames = [p.name + "@GRAD" for p in main.all_parameters()]
    clip_names = sorted(n for n in main.global_block.vars if "@CLIP" in n)
    assert clip_names
    exe = _exe()
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        outs = exe.run(main, feed=FEED,
                       fetch_list=[loss] + gnames + [clip_names[0]])
    grads = outs[1:1 + len(gnames)]
    ref_norm = _np_norm(grads)
    assert logger.recent()[-1]["grad_norm"] == pytest.approx(ref_norm,
                                                             rel=1e-5)
    assert ref_norm > clip_norm
    raw = dict(zip(gnames, grads))
    base = clip_names[0].split("@CLIP")[0]
    np.testing.assert_allclose(outs[-1], raw[base] * clip_norm / ref_norm,
                               rtol=1e-5)


def test_unclipped_grad_norm_tap_built_when_no_clip():
    ts.install_step_logger(ts.StepLogger())
    main, _, _ = build_program(grad_clip=None)
    assert getattr(main, "_global_norm_var", None) is None
    assert "telemetry_grad_norm" in main._train_telemetry["grad_norm"]


def test_trainz_serves_step_scalars_and_recompiles():
    logger = ts.install_step_logger(ts.StepLogger(policy="warn"))
    main, startup, loss = build_program()
    exe = _exe()
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(3):
            exe.run(main, feed=FEED, fetch_list=[loss])
        exe.run(main, feed={"x": np.tile(X0, (2, 1)),
                            "y": np.tile(Y0, (2, 1))}, fetch_list=[loss])
    port = obs.start_debug_server(port=0)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/trainz")
        body = json.loads(conn.getresponse().read())
    finally:
        conn.close()
    assert body["enabled"] and body["policy"] == "warn"
    assert body["steps_total"] == 4 and body["nan_steps"] == 0
    assert [s["step"] for s in body["steps"]] == [1, 2, 3, 4]
    assert body["steps"][-1]["loss"] == logger.recent()[-1]["loss"]
    assert body["recompiles"][-1]["cause"] == "feed_shape"


def test_disabled_plane_is_noop():
    assert ts.get_step_logger() is None
    main, startup, loss = build_program()
    assert getattr(main, "_train_telemetry", None) is None
    assert not any("telemetry" in n for n in main.global_block.vars)
    exe = _exe()
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        outs = exe.run(main, feed=FEED, fetch_list=[loss])
    assert len(outs) == 1
    assert exe.last_fetch_names == [loss.name]
    fams = set(obs.get_registry().snapshot())
    assert not any(f.startswith("train_") or f.startswith("nan_")
                   for f in fams), fams


def test_no_logger_program_is_byte_identical():
    """minimize() with no logger installed builds exactly the program it
    builds without the tap."""
    a, _, _ = build_program()
    ts.install_step_logger(ts.StepLogger())
    b, _, _ = build_program()
    ts.uninstall_step_logger()
    c, _, _ = build_program()
    assert a.serialize_to_string() == c.serialize_to_string()
    assert len(b.global_block.ops) > len(a.global_block.ops)


def test_attached_program_without_logger_adds_no_fetches():
    ts.install_step_logger(ts.StepLogger())
    main, startup, loss = build_program()
    assert main._train_telemetry is not None
    ts.uninstall_step_logger()
    obs.get_registry().reset()
    exe = _exe()
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        outs = exe.run(main, feed=FEED, fetch_list=[loss])
    assert len(outs) == 1
    assert exe.last_fetch_names == [loss.name]
    fams = set(obs.get_registry().snapshot())
    assert not any(f.startswith("train_") or f.startswith("nan_")
                   for f in fams), fams


def test_telemetry_prunes_from_test_clone():
    ts.install_step_logger(ts.StepLogger(policy="skip_step"))
    main, _, _ = build_program()
    for op in main.clone(for_test=True).global_block.ops:
        assert op.type not in ("isfinite", "logical_and"), op.type
        assert not any("@PRE_STEP" in n for n in op.output_names())
