"""Light-NAS: simulated-annealing architecture search + evaluators.

Port of `paddle_tpu/contrib/slim/nas.py` (a copy: it has no JAX in it).

Reference: contrib/slim/searcher/controller.py:58 (SAController),
contrib/slim/nas/search_space.py:18, light_nas_strategy.py:35,
controller_server.py / search_agent.py (socket protocol for distributed
search workers).

Design notes: the reference couples search to its Compressor
callback framework and counts FLOPs on its C++ GraphWrapper; here the
searcher is a plain loop over (tokens -> program -> short train ->
reward) using the standard Executor, and flops() walks the program IR
directly. The controller-server protocol is kept (line-based TCP with a
shared key) so search workers can scale out across hosts exactly like
the reference's search_agent.
"""

from __future__ import annotations

import math
import socket
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

__all__ = ["EvolutionaryController", "SAController", "SearchSpace",
           "flops", "latency_estimate", "LightNASSearcher",
           "ControllerServer", "SearchAgent"]


class EvolutionaryController:
    """Abstract evolutionary controller (reference controller.py:27)."""

    def update(self, tokens, reward):
        raise NotImplementedError("Abstract method.")

    def reset(self, range_table, init_tokens, constrain_func=None):
        raise NotImplementedError("Abstract method.")

    def next_tokens(self):
        raise NotImplementedError("Abstract method.")


class SAController(EvolutionaryController):
    """Simulated annealing over integer token vectors (reference
    controller.py:58). tokens[i] in [0, range_table[i])."""

    def __init__(self, range_table=None, reduce_rate=0.85,
                 init_temperature=1024, max_iter_number=300, seed=None):
        self._range_table = range_table
        self._reduce_rate = reduce_rate
        self._init_temperature = init_temperature
        self._max_iter_number = max_iter_number
        self._rng = np.random.RandomState(seed)
        self._reward = -1.0
        self._tokens = None
        self._max_reward = -1.0
        self._best_tokens = None
        self._iter = 0
        self._constrain_func = None

    @property
    def best_tokens(self):
        return self._best_tokens

    @property
    def max_reward(self):
        return self._max_reward

    def reset(self, range_table, init_tokens, constrain_func=None):
        self._range_table = list(range_table)
        self._constrain_func = constrain_func
        self._tokens = list(init_tokens)
        self._iter = 0
        # a reused controller must not carry bests from a previous space
        # (stale best_tokens could be out of range for the new table)
        self._reward = -1.0
        self._max_reward = -1.0
        self._best_tokens = None

    def update(self, tokens, reward):
        """Accept `tokens` if reward improved, else with the annealing
        probability exp((r - r_prev) / T)."""
        self._iter += 1
        temperature = self._init_temperature * \
            self._reduce_rate ** self._iter
        if (reward > self._reward) or (self._rng.random_sample()
                                       <= math.exp((reward - self._reward)
                                                   / temperature)):
            self._reward = reward
            self._tokens = list(tokens)
        if reward > self._max_reward:
            self._max_reward = reward
            self._best_tokens = list(tokens)

    def next_tokens(self):
        tokens = list(self._tokens)
        new_tokens = list(tokens)
        index = int(len(self._range_table) * self._rng.random_sample())
        new_tokens[index] = (
            new_tokens[index]
            + self._rng.randint(max(self._range_table[index] - 1, 1)) + 1
        ) % self._range_table[index]
        if self._constrain_func is None:
            return new_tokens
        for _ in range(self._max_iter_number):
            if not self._constrain_func(new_tokens):
                index = int(len(self._range_table)
                            * self._rng.random_sample())
                new_tokens = list(tokens)
                new_tokens[index] = self._rng.randint(
                    self._range_table[index])
            else:
                break
        return new_tokens


class SearchSpace:
    """Abstract search space (reference search_space.py:18)."""

    def init_tokens(self) -> List[int]:
        raise NotImplementedError("Abstract method.")

    def range_table(self) -> List[int]:
        raise NotImplementedError("Abstract method.")

    def create_net(self, tokens):
        """tokens -> (startup_program, train_program, eval_fn) — eval_fn
        runs the short train + eval and returns the reward metric."""
        raise NotImplementedError("Abstract method.")


# ---------------------------------------------------------------------------
# evaluators
# ---------------------------------------------------------------------------

def _numel(shape):
    n = 1
    for d in shape or []:
        n *= abs(int(d)) if int(d) != -1 else 1
    return n


def flops(program) -> int:
    """Static FLOP count from the program IR (reference counts on its
    GraphWrapper; same accounting: 2*M*N*K matmuls, 2*prod(out)*Cin*k²
    convs, 1/elt for elementwise + activations)."""
    total = 0
    blk = program.global_block

    def shape_of(name):
        v = blk.vars.get(name)
        return list(v.shape) if v is not None and v.shape else []

    for op in blk.ops:
        t = op.type
        if t in ("mul", "matmul"):
            xs = shape_of(op.input("X")[0])
            ys = shape_of(op.input("Y")[0])
            if xs and ys:
                m = _numel(xs[:-1])
                k = abs(int(xs[-1]))
                n = abs(int(ys[-1]))
                total += 2 * m * k * n
        elif t in ("conv2d", "depthwise_conv2d", "conv2d_transpose"):
            w = shape_of(op.input("Filter")[0])
            outs = shape_of(op.output("Output")[0]) or \
                shape_of(op.input("Input")[0])
            if w and outs:
                k_elems = _numel(w[1:])          # Cin/g * kh * kw
                total += 2 * _numel(outs) * k_elems
        elif t in ("elementwise_add", "elementwise_mul", "elementwise_sub",
                   "relu", "sigmoid", "tanh", "scale", "batch_norm"):
            names = op.input("X")
            if names:
                total += _numel(shape_of(names[0]))
    return total


def latency_estimate(program, flops_per_second=1.0e12,
                     bytes_per_second=1.0e11) -> float:
    """Roofline latency proxy: max(compute, memory) per op, summed — the
    reference's table-driven latency evaluator replaced by a roofline
    model (no per-op device timing tables needed to RANK architectures)."""
    blk = program.global_block
    total = 0.0
    for op in blk.ops:
        f = flops(_SingleOpView(program, op))
        bytes_moved = 0
        for name in list(op.input_names()) + list(op.output_names()):
            v = blk.vars.get(name)
            if v is not None and v.shape:
                bytes_moved += 4 * _numel(v.shape)
        total += max(f / flops_per_second,
                     bytes_moved / bytes_per_second)
    return total


class _SingleOpView:
    """flops() over one op without copying the program."""

    def __init__(self, program, op):
        self.global_block = _SingleOpBlock(program.global_block, op)


class _SingleOpBlock:
    def __init__(self, block, op):
        self.vars = block.vars
        self.ops = [op]


# ---------------------------------------------------------------------------
# the search loop (LightNASStrategy analog)
# ---------------------------------------------------------------------------

class LightNASSearcher:
    """Drive (controller x search-space) for `search_steps` rounds
    (reference light_nas_strategy.py:35 — without the Compressor
    callback scaffolding; the loop IS the strategy)."""

    def __init__(self, search_space: SearchSpace,
                 controller: Optional[EvolutionaryController] = None,
                 target_flops: Optional[int] = None,
                 search_steps: int = 10):
        self._space = search_space
        self._controller = controller or SAController(seed=0)
        self._target_flops = target_flops
        self._steps = search_steps
        self.history: List[tuple] = []

    def _constrain(self, tokens) -> bool:
        if self._target_flops is None:
            return True
        built = self._space.create_net(tokens)
        program = built[1]
        return flops(program) <= self._target_flops

    def search(self):
        """Returns (best_tokens, best_reward)."""
        init = self._space.init_tokens()
        self._controller.reset(self._space.range_table(), init,
                               self._constrain)
        for _ in range(self._steps):
            tokens = self._controller.next_tokens()
            startup, train, eval_fn = self._space.create_net(tokens)
            if self._target_flops is not None and \
                    flops(train) > self._target_flops:
                # infeasible even after the constrain-loop's retries: do
                # NOT feed it to the controller — a 0.0 reward would beat
                # the initial max_reward and leak budget-violating tokens
                # out as best_tokens
                self.history.append((list(tokens), None))
                continue
            reward = float(eval_fn(startup, train))
            self._controller.update(tokens, reward)
            self.history.append((list(tokens), reward))
        return self._controller.best_tokens, self._controller.max_reward


# ---------------------------------------------------------------------------
# distributed search: controller server + agent (reference
# controller_server.py / search_agent.py — line protocol "key tokens
# reward" -> next tokens)
# ---------------------------------------------------------------------------

class ControllerServer:
    def __init__(self, controller, address=("127.0.0.1", 0),
                 max_client_num=100, key="light-nas"):
        self._controller = controller
        self._key = key
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(address)
        self._sock.listen(max_client_num)
        self._port = self._sock.getsockname()[1]
        self._ip = self._sock.getsockname()[0]
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    @property
    def ip(self):
        return self._ip

    @property
    def port(self):
        return self._port

    def _serve(self):
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with conn:
                # one malformed client must not kill the serve loop (it
                # would strand every other agent with no visible error)
                try:
                    data = conn.recv(4096).decode()
                    parts = data.strip().split("\t")
                    if len(parts) != 3 or parts[0] != self._key:
                        conn.sendall(b"err\tbad key")
                        continue
                    tokens = [int(t) for t in parts[1].split(",") if t]
                    reward = float(parts[2])
                    with self._lock:
                        if tokens:
                            self._controller.update(tokens, reward)
                        nxt = self._controller.next_tokens()
                    conn.sendall(",".join(str(t) for t in nxt).encode())
                except Exception as e:  # noqa: BLE001
                    try:
                        conn.sendall(f"err\t{e}".encode())
                    except OSError:
                        pass

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class SearchAgent:
    def __init__(self, server_ip, server_port, key="light-nas"):
        self._addr = (server_ip, server_port)
        self._key = key

    def next_tokens(self, tokens: Sequence[int] = (),
                    reward: float = -1.0) -> List[int]:
        """Report (tokens, reward), receive the next tokens to try."""
        with socket.create_connection(self._addr, timeout=10) as s:
            msg = "\t".join([self._key,
                             ",".join(str(t) for t in tokens),
                             repr(float(reward))])
            s.sendall(msg.encode())
            data = s.recv(4096).decode()
        if data.startswith("err"):
            raise RuntimeError(f"controller server refused: {data}")
        return [int(t) for t in data.split(",") if t]
