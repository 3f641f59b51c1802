"""DeepFM sparse-PS throughput: the port of tools/bench_deepfm_ps.py
(BASELINE.json's "DeepFM / wide&deep CTR: throughput w/ sparse PS path"
row), on the card.

Criteo-like shape: 26 sparse fields over a 1e5-slot vocabulary, embedding
16, batch 512, fc (400, 400), no dense features, Adam 1e-3 applied on the
server. The sparse tables live on local pskv C++ servers (loopback); every
step pulls the touched rows, runs the trainer's step on the card, and
pushes the sparse gradients back as rows and values: the whole sync-PS
data path (transpiler -> PSPlan -> pskv).

    python3 -m paddle_tpu_torch.tools.bench_deepfm_ps

Knobs (as in the JAX bench): BENCH_BATCH, BENCH_VOCAB, BENCH_STEPS,
BENCH_SERVERS. The trainer runs on CUDAPlace(0); BENCH_DEVICE=cpu runs it
on the CPU. Prints one JSON line: samples/s, with the step time, the
card and its power limit in `unit`.
"""

import json
import os
import socket
import subprocess
import time

import numpy as np

FIELDS = 26
EMB = 16
LAYERS = (400, 400)
LR = 1e-3


def free_endpoints(n):
    """n loopback endpoints on free ports."""
    eps = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        eps.append(f"127.0.0.1:{s.getsockname()[1]}")
        s.close()
    return eps


def build(vocab, fields=FIELDS, emb=EMB, layers=LAYERS, lr=LR, seed=0,
          optimizer="adam"):
    """The bench's DeepFM train program (Adam, or SGD with
    optimizer="sgd"): (main, startup, spec)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models.deepfm import deepfm
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name_guard(), ptt.program_guard(main, startup):
        spec = deepfm(num_fields=fields, sparse_feature_dim=vocab,
                      embedding_size=emb, dense_dim=0, layer_sizes=layers)
        opt = ptt.optimizer.SGD if optimizer == "sgd" else \
            ptt.optimizer.Adam
        opt(learning_rate=lr).minimize(spec["loss"])
    main.random_seed = startup.random_seed = seed
    return main, startup, spec


def transpile(main, startup, endpoints, trainer_id=0, trainers=1,
              sync=True):
    """Rewrite `main` for the PS (in place); returns the transpiler."""
    from paddle_tpu_torch.transpiler import DistributeTranspiler
    t = DistributeTranspiler()
    t.transpile(trainer_id, program=main, pservers=",".join(endpoints),
                trainers=trainers, sync_mode=sync, startup_program=startup)
    return t


def batches(seed, batch, vocab, fields=FIELDS):
    """The JAX bench's stream: uniform ids, label = parity of their sum."""
    rng = np.random.RandomState(seed)
    while True:
        ids = rng.randint(0, vocab, (batch, fields)).astype(np.int64)
        label = (ids.sum(axis=1) % 2).astype(np.float32)[:, None]
        yield {"feat_ids": ids, "label": label}


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None


def run(batch=512, vocab=100000, steps=100, servers=1, device=None):
    """Warm up one step, then time `steps` sync-PS steps (host clock; each
    step ends with its gradients on the host and the dense params pulled).
    Returns the bench's row."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.transpiler import start_pserver
    endpoints = free_endpoints(servers)
    main, startup, spec = build(vocab)
    t = transpile(main, startup, endpoints)
    srvs = [start_pserver(t.get_pserver_program(ep)) for ep in endpoints]
    plan = main._ps_plan
    n_sparse = sum(1 for sp in plan.specs if sp.sparse)
    place = ptt.CPUPlace() if device == "cpu" else None
    exe, scope = ptt.Executor(place), ptt.Scope()
    feeds = batches(0, batch, vocab)
    try:
        exe.run(startup, scope=scope)
        exe.run(main, feed=next(feeds), fetch_list=[spec["loss"]],
                scope=scope)                                   # warm-up
        t0 = time.perf_counter()
        for _ in range(steps):
            last = exe.run(main, feed=next(feeds),
                           fetch_list=[spec["loss"]], scope=scope)[0]
        dt = (time.perf_counter() - t0) / steps
    finally:
        plan.shutdown()
        for srv in srvs:
            srv.stop()
    on_card = exe.device.type == "cuda"
    card = card_line() if on_card else None
    where = (f"{torch.cuda.get_device_name(0)} ({card})" if on_card
             else "CPU")
    return {
        "metric": f"deepfm_sparse_ps_samples_per_s_{servers}srv",
        "value": round(batch / dt, 1),
        "unit": (f"samples/s (batch={batch} fields={FIELDS} vocab={vocab} "
                 f"emb={EMB}, {dt * 1e3:.1f} ms/step, {n_sparse} sparse "
                 f"tables sharded over {servers} pskv server(s), "
                 f"loss={float(np.ravel(last)[0]):.3f}; trainer on "
                 f"{where})"),
    }


def main():
    print(json.dumps(run(
        batch=int(os.environ.get("BENCH_BATCH", "512")),
        vocab=int(os.environ.get("BENCH_VOCAB", "100000")),
        steps=int(os.environ.get("BENCH_STEPS", "100")),
        servers=int(os.environ.get("BENCH_SERVERS", "1")),
        device=os.environ.get("BENCH_DEVICE") or None)))


if __name__ == "__main__":
    main()
