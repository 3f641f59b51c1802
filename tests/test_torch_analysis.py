"""The port's static program verifier (paddle_tpu_torch.analysis) against the
JAX package's, on the CPU.

Programs from tests/test_analysis.py's defect corpus are built the same
way in both packages and verified by each; the diagnostics must agree in
code, op index, op type and var (the messages too, except PT-E006's trace
failure, which quotes the backend's own error). The port's GPT and BERT
training programs verify clean, and the Executor surfaces: run(...,
validate=True) raises ProgramVerificationError before any op runs,
validate is memoized and leaves the program's bytes and version as they
were.
"""

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.analysis import verify_program as jax_verify
from paddle_tpu_torch.analysis import (ProgramVerificationError,
                                       verify_program)
from torch_port_common import one_torch_thread  # noqa: F401


def _relu_on(pkg, x_data, out="o", role=None):
    p = pkg.Program()
    blk = p.global_block
    if x_data:
        blk.create_var(name="x", shape=(4,), is_data=True)
    blk.create_var(name=out, shape=(4,))
    blk.append_op("relu", {"X": ["x" if x_data else "ghost"]},
                  {"Out": [out]}, {"op_role": role} if role else {},
                  infer_shape=False)
    return p


def _read_before_write(pkg):
    p = pkg.Program()
    blk = p.global_block
    blk.create_var(name="x", shape=(4,))
    blk.create_var(name="o", shape=(4,))
    blk.append_op("relu", {"X": ["x"]}, {"Out": ["o"]}, infer_shape=False)
    return p


def _cycle(pkg):
    p = pkg.Program()
    blk = p.global_block
    blk.create_var(name="a", shape=(4,))
    blk.create_var(name="b", shape=(4,))
    blk.append_op("relu", {"X": ["a"]}, {"Out": ["b"]}, infer_shape=False)
    blk.append_op("relu", {"X": ["b"]}, {"Out": ["a"]}, infer_shape=False)
    return p


def _unknown_op(pkg):
    p = pkg.Program()
    blk = p.global_block
    blk.create_var(name="x", shape=(4,), is_data=True)
    blk.create_var(name="o", shape=(4,))
    blk.append_op("totally_bogus_frobnicate", {"X": ["x"]}, {"Out": ["o"]},
                  infer_shape=False)
    return p


def _matmul(pkg, y_shape, o_shape):
    p = pkg.Program()
    blk = p.global_block
    blk.create_var(name="x", shape=(2, 3), is_data=True)
    blk.create_var(name="y", shape=y_shape, is_data=True)
    blk.create_var(name="o", shape=o_shape)
    blk.append_op("matmul", {"X": ["x"], "Y": ["y"]}, {"Out": ["o"]},
                  infer_shape=False)
    return p


def _declared_mismatch(pkg):
    p = pkg.Program()
    blk = p.global_block
    blk.create_var(name="x", shape=(2, 3), is_data=True)
    blk.create_var(name="o", shape=(9, 9))
    blk.append_op("relu", {"X": ["x"]}, {"Out": ["o"]}, infer_shape=False)
    return p


def _orphan_grad(pkg):
    p = pkg.Program()
    blk = p.global_block
    blk.create_var(name="g", shape=(4,), is_data=True)
    blk.create_var(name="o", shape=(4,))
    blk.append_op("bogus_fwd_grad", {"Out@GRAD": ["g"]}, {"X@GRAD": ["o"]},
                  infer_shape=False)
    return p


def _dead_op(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4])
        pkg.layers.relu(x)                       # never fetched
        live = pkg.layers.mean(pkg.layers.scale(x, scale=2.0))
    return main, [live]


def _orphan_var(pkg):
    p = pkg.Program()
    blk = p.global_block
    blk.create_var(name="x", shape=(4,), is_data=True)
    blk.create_var(name="orphan", shape=(2,))
    blk.append_op("relu", {"X": ["x"]}, {"Out": ["o"]})
    return p


def _shadowed_write(pkg):
    p = pkg.Program()
    blk = p.global_block
    blk.create_var(name="t", shape=(4,))
    for v in (1.0, 2.0):
        blk.append_op("fill_constant", {}, {"Out": ["t"]},
                      {"shape": [4], "dtype": "float32", "value": v},
                      infer_shape=False)
    blk.append_op("relu", {"X": ["t"]}, {"Out": ["o"]})
    return p


def _stop_gradient_written(pkg):
    p = pkg.Program()
    blk = p.global_block
    blk.create_var(name="v", shape=(4,), is_data=True, stop_gradient=True)
    blk.create_var(name="v@GRAD", shape=(4,))
    blk.append_op("fill_constant", {}, {"Out": ["v@GRAD"]},
                  {"shape": [4], "dtype": "float32", "value": 0.0},
                  infer_shape=False)
    return p


def _leaked_batch(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4])
        pkg.layers.reshape(x, [-1])   # folds the batch into features
    return main


def _clean_trained(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4])
        y = pkg.layers.data("y", [1], dtype="int64")
        logits = pkg.layers.fc(pkg.layers.fc(x, 8, act="relu"), 3)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        pkg.optimizer.Adam(0.01).minimize(loss)
    return main, [loss]


# (case id, build(pkg) -> program or (program, fetches), codes that fire)
_CORPUS = [
    ("e001_undefined", lambda pkg: _relu_on(pkg, False), {"PT-E001"}),
    ("e002_read_before_write", _read_before_write, {"PT-E002"}),
    ("e003_cycle", _cycle, {"PT-E003"}),
    ("e004_unknown_op", _unknown_op, {"PT-E004"}),
    ("e005_bad_op_role",
     lambda pkg: _relu_on(pkg, True, role="sideways"), {"PT-E005"}),
    ("e006_trace_failure", lambda pkg: _matmul(pkg, (4, 5), (2, 5)),
     {"PT-E006"}),
    ("e006_declared_mismatch", _declared_mismatch, {"PT-E006"}),
    ("e006_negative", lambda pkg: _matmul(pkg, (3, 5), (2, 5)), set()),
    ("e007_orphan_grad", _orphan_grad, {"PT-E007"}),
    ("w101_dead_op", _dead_op, {"PT-W101"}),
    ("w102_orphan_var", _orphan_var, {"PT-W102"}),
    ("w103_shadowed_write", _shadowed_write, {"PT-W103"}),
    ("w105_stop_gradient", _stop_gradient_written, {"PT-W105"}),
    ("w107_leaked_batch", _leaked_batch, {"PT-W107"}),
    ("clean_trained", _clean_trained, set()),
]


def _verify(pkg, build):
    built = build(pkg)
    prog, fetches = built if isinstance(built, tuple) else (built, None)
    rep = (jax_verify if pkg is pt else verify_program)(
        prog, fetch_list=fetches)
    return rep


def _key(d, with_message):
    return (d.code, d.block_idx, d.op_idx, d.op_type, d.var) + (
        (d.message,) if with_message else ())


@pytest.mark.parametrize("case", _CORPUS, ids=[c[0] for c in _CORPUS])
def test_diagnostics_match_jax(case):
    name, build, fires = case
    j, t = _verify(pt, build), _verify(ptt, build)
    msgs = name != "e006_trace_failure"
    assert [_key(d, msgs) for d in t.diagnostics] == \
        [_key(d, msgs) for d in j.diagnostics]
    assert {d.code for d in t.diagnostics} == fires
    assert t.ok == j.ok


@pytest.mark.parametrize("amp", [False, True])
def test_port_training_programs_verify_clean(amp):
    from paddle_tpu_torch.models.bert import BertConfig, bert_pretrain_program
    from paddle_tpu_torch.models.gpt import GPTConfig, gpt_lm_program
    cfg = GPTConfig(vocab_size=96, hidden=32, layers=2, heads=2,
                    max_pos=64, attn_impl="fused")
    with ptt.unique_name_guard():
        main, startup, f = gpt_lm_program(cfg, 64, learning_rate=1e-3,
                                          amp=amp)
    for prog, fetch in ((main, [f["loss"]]), (startup, None)):
        rep = verify_program(prog, fetch_list=fetch)
        assert not rep.diagnostics, rep.render()
    bcfg = BertConfig(vocab_size=96, hidden=32, layers=2, heads=2, ffn=64,
                      max_pos=64)
    with ptt.unique_name_guard():
        main, _, f = bert_pretrain_program(bcfg, 16, amp=amp)
    rep = verify_program(main, fetch_list=[f["loss"]])
    assert not rep.diagnostics, rep.render()


def test_executor_validate_raises_before_any_op():
    p = _matmul(ptt, (4, 5), (2, 5))
    exe = ptt.Executor(ptt.CPUPlace())
    feed = {"x": np.zeros((2, 3), np.float32),
            "y": np.zeros((4, 5), np.float32)}
    with pytest.raises(ProgramVerificationError) as ei:
        exe.run(p, feed=feed, fetch_list=["o"], validate=True)
    msg = str(ei.value)
    assert "PT-E006" in msg and "matmul" in msg and "op #0" in msg
    assert exe.compile_count == 0


def test_executor_validate_is_memoized_and_read_only():
    p = ptt.Program()
    blk = p.global_block
    blk.create_var(name="x", shape=(-1, 4), is_data=True)
    blk.append_op("relu", {"X": ["x"]}, {"Out": ["o"]})
    feed = {"x": np.ones((2, 4), np.float32)}
    before = (p.serialize_to_string(), p.version)
    off = ptt.Executor(ptt.CPUPlace())
    r_off, = off.run(p, feed=feed, fetch_list=["o"], scope=ptt.Scope())
    on = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    r_on, = on.run(p, feed=feed, fetch_list=["o"], validate=True,
                   scope=scope)
    on.run(p, feed=feed, fetch_list=["o"], validate=True, scope=scope)
    np.testing.assert_array_equal(r_off, r_on)
    assert off.compile_count == on.compile_count == 1
    assert len(on._validated) == 1
    assert (p.serialize_to_string(), p.version) == before
    rep = p.validate(fetch_list=["o"])
    assert rep.ok and (p.serialize_to_string(), p.version) == before
