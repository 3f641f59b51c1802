"""One process of a parameter-server job, for
`python -m paddle_tpu_torch.distributed.launch --server_num=S
--worker_num=W paddle_tpu_torch/tools/dist_ps_runner.py`.

Port of the JAX package's tests/dist_ps_runner.py (the reference's
dist_mnist.py / dist_ctr.py pattern). The role comes from TRAINING_ROLE
(distributed.launch sets it): a pserver serves until trainer 0 sends
shutdown; a trainer runs STEPS steps of the model and writes its losses to
$DIST_PS_OUT/worker.<id>.json.

DIST_PS_MODE picks the model: dense (an fc model, sync PS) or sparse (an
is_sparse embedding over a remote sparse table, sync PS). Trainers run on
the card; DIST_PS_DEVICE=cpu runs them on the CPU. `build_model` and
`make_feed` are also what a single-process baseline of the same job
builds and feeds.
"""

import json
import os
import sys

import numpy as np

STEPS = 6
SEED = 9


def build_model(pkg, sparse):
    """The job's model in the `pkg` DSL (either package); returns the
    loss."""
    L = pkg.layers
    if sparse:
        ids = L.data("ids", [1], dtype="int64")
        x = L.embedding(ids, size=[50, 8], is_sparse=True)
    else:
        x = L.data("x", [8], dtype="float32")
    label = L.data("label", [1], dtype="float32")
    h = L.fc(x, size=16, act="relu")
    pred = L.fc(h, size=1)
    return L.mean(L.square(pred - label))


def make_feed(rng, sparse):
    if sparse:
        ids = rng.randint(0, 50, (16, 1)).astype(np.int64)
        return {"ids": ids, "label": ids.astype(np.float32) / 50.0}
    x = rng.randn(16, 8).astype(np.float32)
    return {"x": x, "label": x.sum(1, keepdims=True).astype(np.float32)}


def main():
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.incubate.fleet.base.role_maker import (
        PaddleCloudRoleMaker)
    from paddle_tpu_torch.incubate.fleet.parameter_server import PSFleet

    sparse = os.environ.get("DIST_PS_MODE", "dense") == "sparse"
    fleet = PSFleet()
    fleet.init(PaddleCloudRoleMaker())
    main_p, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name_guard(), ptt.program_guard(main_p, startup):
        loss = build_model(ptt, sparse)
        fleet.distributed_optimizer(ptt.optimizer.SGD(
            learning_rate=0.05)).minimize(loss, startup_program=startup)
    main_p.random_seed = startup.random_seed = SEED

    if fleet.is_server():
        fleet.run_server()  # blocks until a trainer sends shutdown
        return

    place = ptt.CPUPlace() if os.environ.get("DIST_PS_DEVICE") == "cpu" \
        else None
    exe = ptt.Executor(place)
    scope = ptt.Scope()
    rng = np.random.RandomState(0)  # same data on every worker: lockstep
    plan = fleet.main_program._ps_plan
    exe.run(startup, scope=scope)
    losses = []
    for _ in range(STEPS):
        (lv,) = exe.run(fleet.main_program, feed=make_feed(rng, sparse),
                        fetch_list=[loss], scope=scope)
        losses.append(float(np.ravel(lv)[0]))
    wid = fleet.worker_index()
    with open(os.path.join(os.environ["DIST_PS_OUT"],
                           f"worker.{wid}.json"), "w") as f:
        json.dump(losses, f)
    # worker 0 shuts the servers down once everyone is done (the barrier
    # keeps it from stopping a server mid-round)
    for ep in plan.endpoints:
        plan._client(ep).barrier()
    plan.shutdown(stop_servers=(wid == 0))


if __name__ == "__main__":
    main()
    sys.exit(0)
