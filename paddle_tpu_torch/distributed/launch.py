"""Multi-process training launcher.

Copy of `paddle_tpu/distributed/launch.py` (it imports no JAX).
Reference: python/paddle/distributed/launch.py:132 `start_procs` — spawns
trainer processes with PADDLE_TRAINER_ID / PADDLE_CURRENT_ENDPOINT /
PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ENDPOINTS env vars; with
--server_num/--worker_num, parameter-server jobs (pservers and trainers on
this host, wired through TRAINING_ROLE / PADDLE_PSERVERS_IP_PORT_LIST,
which PaddleCloudRoleMaker reads). --nproc_per_node defaults to 1.

Usage:
    python -m paddle_tpu_torch.distributed.launch --hosts=ip1,ip2 train.py
    python -m paddle_tpu_torch.distributed.launch --server_num=1 \
        --worker_num=2 train.py ...
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

__all__ = ["launch", "build_env"]


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="paddle_tpu_torch distributed training launcher")
    p.add_argument("--cluster_node_ips", "--hosts", dest="hosts",
                   type=str, default="127.0.0.1",
                   help="comma-separated host ips")
    p.add_argument("--node_ip", type=str, default="127.0.0.1",
                   help="this node's ip")
    p.add_argument("--started_port", type=int, default=6170)
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes per host")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--server_num", type=int, default=0,
                   help="parameter-server mode: pserver process count")
    p.add_argument("--worker_num", type=int, default=0,
                   help="parameter-server mode: trainer process count")
    p.add_argument("--dry_run", action="store_true",
                   help="print per-process env and exit (for tests)")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def build_env(rank: int, args) -> dict:
    hosts = [h for h in args.hosts.split(",") if h]
    nnodes = len(hosts)
    world = nnodes * args.nproc_per_node
    endpoints = [f"{h}:{args.started_port + i}" for h in hosts
                 for i in range(args.nproc_per_node)]
    env = dict(os.environ)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "PADDLE_NUM_PROCESSES": str(world),
        "PADDLE_COORDINATOR_ADDRESS":
            f"{hosts[0]}:{args.started_port + 9000}",
    })
    return env


def build_ps_envs(args):
    """Parameter-server mode env assembly (reference launch_ps):
    server_num pservers + worker_num trainers on this host, wired through
    the TRAINING_ROLE / PADDLE_PSERVERS_IP_PORT_LIST convention that
    PaddleCloudRoleMaker reads."""
    server_eps = [f"127.0.0.1:{args.started_port + i}"
                  for i in range(args.server_num)]
    envs = []
    for i, ep in enumerate(server_eps):
        env = dict(os.environ)
        env.update({
            "TRAINING_ROLE": "PSERVER",
            "POD_IP": "127.0.0.1",
            "PADDLE_PORT": ep.rsplit(":", 1)[1],
            "PADDLE_PSERVERS_IP_PORT_LIST": ",".join(server_eps),
            "PADDLE_TRAINERS_NUM": str(args.worker_num),
        })
        envs.append((f"server.{i}", env))
    for i in range(args.worker_num):
        env = dict(os.environ)
        env.update({
            "TRAINING_ROLE": "TRAINER",
            "PADDLE_TRAINER_ID": str(i),
            "PADDLE_PSERVERS_IP_PORT_LIST": ",".join(server_eps),
            "PADDLE_TRAINERS_NUM": str(args.worker_num),
        })
        envs.append((f"worker.{i}", env))
    return envs


def launch(argv=None) -> int:
    args = _parse_args(argv)
    if args.server_num or args.worker_num:
        return _launch_ps(args)
    hosts = [h for h in args.hosts.split(",") if h]
    node_rank = hosts.index(args.node_ip) if args.node_ip in hosts else 0
    local_ranks = range(node_rank * args.nproc_per_node,
                        (node_rank + 1) * args.nproc_per_node)

    if args.dry_run:
        for rank in local_ranks:
            env = build_env(rank, args)
            print(f"rank={rank} endpoint={env['PADDLE_CURRENT_ENDPOINT']} "
                  f"world={env['PADDLE_TRAINERS_NUM']}")
        return 0

    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)

    procs = []
    for rank in local_ranks:
        env = build_env(rank, args)
        cmd = [sys.executable, "-u", args.training_script,
               *args.training_script_args]
        stdout = None
        if args.log_dir:
            stdout = open(os.path.join(args.log_dir,
                                       f"worker.{rank}.log"), "w")
        procs.append((subprocess.Popen(cmd, env=env, stdout=stdout,
                                       stderr=subprocess.STDOUT
                                       if stdout else None), stdout))

    def _terminate(*_):
        for p, _f in procs:
            if p.poll() is None:
                p.terminate()

    signal.signal(signal.SIGTERM, _terminate)
    rc = 0
    try:
        while procs:
            alive = []
            for p, f in procs:
                ret = p.poll()
                if ret is None:
                    alive.append((p, f))
                elif ret != 0:
                    rc = ret
                    _terminate()
            procs = alive
            if rc:
                for p, _f in procs:
                    p.wait()
                break
            time.sleep(0.2)
    finally:
        _terminate()
    return rc


def _launch_ps(args) -> int:
    if args.dry_run:
        for tag, env in build_ps_envs(args):
            role = env.get("TRAINING_ROLE")
            print(f"{tag} role={role} "
                  f"servers={env.get('PADDLE_PSERVERS_IP_PORT_LIST')} "
                  f"trainers={env.get('PADDLE_TRAINERS_NUM')}")
        return 0
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    procs = []
    for tag, env in build_ps_envs(args):
        cmd = [sys.executable, "-u", args.training_script,
               *args.training_script_args]
        stdout = None
        if args.log_dir:
            stdout = open(os.path.join(args.log_dir, f"{tag}.log"), "w")
        procs.append((tag, subprocess.Popen(
            cmd, env=env, stdout=stdout,
            stderr=subprocess.STDOUT if stdout else None), stdout))

    rc = 0
    try:
        # workers finishing cleanly ends the job; pservers are told to
        # shut down by trainer 0 (plan.shutdown(stop_servers=True)) or
        # terminated here once every worker exited
        while True:
            workers = [(t, p) for t, p, _f in procs
                       if t.startswith("worker")]
            if all(p.poll() is not None for _t, p in workers):
                # any nonzero (including signal-negative) code is failure
                rc = next((p.poll() for _t, p in workers if p.poll()), 0)
                break
            for t, p, _f in procs:
                if t.startswith("worker") and p.poll() is not None \
                        and p.poll() != 0:
                    rc = p.poll()
            if rc:
                break
            time.sleep(0.2)
    finally:
        for _t, p, _f in procs:
            if p.poll() is None:
                p.terminate()
        for _t, p, _f in procs:
            try:
                p.wait(timeout=10)
            except Exception:
                p.kill()
    return rc


if __name__ == "__main__":
    sys.exit(launch())
