"""The port's benchmark entry points on the CPU, at tiny configs.

`bench_bert.run` and `bench_gpt.run` print bench.py's keys (`metric`,
`value`, `unit`, `vs_baseline`) and `extra`, with a finite loss; on the CPU
the device numbers are None (no CPU time under a device metric's name).
bench_gpt's telemetry segment recompiles exactly once, for the fetch list,
and reports no NaN step. The `--mixed` and `--rebalance` workloads of
`bench_serving` give the rows tests/test_tooling.py pins for the JAX tool,
streams asserted identical inside each workload. The unported switches
raise naming their ROADMAP items.
"""

import json

import numpy as np
import pytest

from paddle_tpu_torch.models.bert import BertConfig
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.observability import get_registry
from paddle_tpu_torch.tools import bench_bert, bench_gpt, bench_serving
from torch_port_common import one_torch_thread  # noqa: F401


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}


@pytest.fixture(autouse=True)
def _fresh_registry():
    get_registry().reset()
    yield
    get_registry().reset()


def test_bench_bert_run_tiny_on_cpu():
    cfg = BertConfig(vocab_size=96, hidden=32, layers=2, heads=2, ffn=64,
                     max_pos=64)
    row = bench_bert.run(cfg, 16, 4, 2, True, device="cpu")
    json.dumps(row)
    assert set(row) == BENCH_KEYS
    assert row["metric"] == "bert_base_train_mfu"
    assert row["value"] is None and row["vs_baseline"] is None
    assert "not measured" in row["unit"]
    e = row["extra"]
    assert np.isfinite(e["loss"]) and e["device"] == "cpu"
    assert e["amp"] is True and e["attn"] == "einsum"
    assert "step_ms" not in e and e["cpu_step_ms"] > 0


def test_bench_gpt_run_tiny_on_cpu():
    cfg = GPTConfig(vocab_size=97, hidden=32, layers=2, heads=4, max_pos=64)
    row = bench_gpt.run(cfg, 16, 2, 2, True, device="cpu", tele_steps=2)
    json.dumps(row)
    assert set(row) == BENCH_KEYS
    assert row["metric"] == "gpt2_small_train_mfu"
    assert row["value"] is None
    e = row["extra"]
    assert np.isfinite(e["loss"]) and e["attn"] == "fused"
    assert e["recompiles_total"] == 1.0     # the telemetry fetch list
    assert e["nan_steps"] == 0.0
    assert e["telemetry_steps"] == 2
    assert np.isfinite(e["grad_norm"]) and e["grad_norm"] > 0
    assert e["counted_flops"] > 0
    assert e["verify_ms"] >= 0
    rc = get_registry().snapshot()["executor_recompiles_total"]["series"]
    assert [s["labels"]["cause"] for s in rc] == ["fetch_list"]


def test_bench_result_line_on_the_card_is_mfu():
    """The card's branch of the row, with a given step time."""
    row = bench_bert.result_line("m", 3e12, 0.01, 8, 128, 100e12, "cpu", {})
    assert row["value"] is None
    import unittest.mock as mock
    with mock.patch.object(bench_bert, "card_line",
                           return_value="NVIDIA H100 80GB HBM3, 700.00 W"):
        row = bench_bert.result_line("m", 3e12, 0.01, 8, 128, 100e12,
                                     "cuda", {})
    assert row["value"] == pytest.approx(3.0)
    assert row["vs_baseline"] == pytest.approx(3.0 / 0.45, rel=1e-3)
    assert row["extra"]["device"].startswith("NVIDIA H100")
    assert row["extra"]["step_ms"] == pytest.approx(10.0)


def test_bench_entry_points_dispatch_and_raise(monkeypatch):
    monkeypatch.setenv("BENCH_MODEL", "gpt2")
    monkeypatch.setattr(bench_gpt, "main", lambda: "gpt")
    assert bench_bert.main() == "gpt"
    monkeypatch.setenv("BENCH_MODEL", "bert")
    monkeypatch.setenv("BENCH_RECOMPUTE", "1")
    with pytest.raises(NotImplementedError, match="A.9"):
        bench_bert.main()
    monkeypatch.undo()
    monkeypatch.setenv("BENCH_PROFILE", "/tmp/prof")
    with pytest.raises(NotImplementedError, match="A.12"):
        bench_gpt.main()


def test_bench_serving_mixed_rows():
    rows = bench_serving.run_mixed("tiny", requests=2, short_max_new=8,
                                   device="cpu")
    assert len(rows) == 2
    off, on = rows
    assert off["metric"] == "tiny_serving_mixed_chunk0"
    assert on["metric"].startswith("tiny_serving_mixed_chunk")
    assert on["metric"] != off["metric"]
    for row in rows:
        assert row["value"] > 0 and row["unit"] == "tokens/s"
        e = row["extra"]
        assert e["p99_tpot_ms"] is not None and e["p99_tpot_ms"] > 0
        assert e["long_ttft_ms"] > 0
        assert e["streams_identical"] is True
        assert e["compiled_executables"] > 0
    assert off["extra"]["prefill_chunk"] is None
    assert off["extra"]["prefill_chunks"] == 0
    assert off["extra"]["prefill_chunk_ms"] is None
    assert on["extra"]["prefill_chunk"] >= 1
    assert on["extra"]["prefill_chunks"] >= 4
    assert on["extra"]["prefill_chunk_ms"] > 0
    assert on["extra"]["p99_tpot_improvement"] is not None
    assert on["extra"]["long_ttft_ratio"] is not None


def test_bench_serving_rebalance_row():
    row, = bench_serving.run_rebalance("tiny", requests=6, device="cpu")
    assert row["metric"] == "tiny_serving_rebalance_r2"
    assert row["value"] > 0 and row["unit"] == "tokens/s"
    e = row["extra"]
    assert e["requests"] == 6 and e["replicas"] == 2
    assert e["migrations"] >= 1
    assert e["migrations_off"] == 0
    assert e["migration_ms"] is not None and e["migration_ms"] > 0
    assert e["migration_failures"] == 0
    for k in ("p99_tpot_ms_on", "p99_tpot_ms_off", "p99_ttft_ms_on",
              "p99_ttft_ms_off"):
        assert e[k] is not None, k
    assert e["tokens_per_s_off"] > 0
    snap = get_registry().snapshot()
    assert not snap.get("server_migrations_total", {}).get("series")


def test_bench_serving_cli_takes_mixed(monkeypatch, capsys):
    """--mixed and --rebalance are workloads of the CLI now, exclusive
    with the other workload switches."""
    calls = []
    monkeypatch.setattr(bench_serving, "run_mixed",
                        lambda name, device: calls.append(
                            ("mixed", name, device)) or [])
    monkeypatch.setattr(bench_serving, "run_rebalance",
                        lambda name, device: calls.append(
                            ("rebalance", name, device)) or [])
    bench_serving.main(["tiny", "--device", "cpu", "--mixed"])
    bench_serving.main(["tiny", "--device", "cpu", "--rebalance"])
    assert calls == [("mixed", "tiny", "cpu"), ("rebalance", "tiny", "cpu")]
    with pytest.raises(SystemExit):
        bench_serving.main(["tiny", "--mixed", "--rebalance"])
