"""Host-boundary IO and distributed op types, and the pure distributed
compute ops (reference: save_op.cc, load_op.cc, save_combine_op.cc,
load_combine_op.cc, operators/distributed_ops/,
lookup_sparse_table_op.cc).

Port of `paddle_tpu/ops/io_dist_ops.py`. Side-effect ops are host ops
(registry.register_host_op) that the executor runs against the scope
outside the op sequence, those before the first compute op in the prefix,
those after the last in the suffix:
  * save/load: the files are the JAX package's, byte for byte: `save`
    writes one .npy per var (np.save), `save_combine` one .npz (np.savez),
    so a file either package writes loads in the other. A save copies its
    tensors to the host in one synchronised batch (io._host_arrays); a
    load places them on the executor's device, in the var's declared dtype;
  * the RPC ops (send, send_barrier, fetch_barrier, recv, prefetch,
    checkpoint_notify, listen_and_serv, fl_listen_and_serv, gen_nccl_id)
    over the pskv service (distributed/pskv.py), not gRPC. A send copies
    its vars to the host in one batch; recv and prefetch place what they
    pull on the executor's device. gen_nccl_id is a recorded no-op that
    writes an int32 zero, as in JAX (the collective bootstrap is not this
    op's).
The data-shuffling ops (fake_init, split_byref, split_ids, merge_ids,
ref_by_trainer_id, lookup_sparse_table) are compute ops like any other.

The clients the RPC ops open are cached per (endpoint, trainer id) in this
process (reference: grpc_client.cc's channel map); `close_clients()`
closes them.
"""

import os

import numpy as np
import torch

from ..framework.registry import register_host_op, register_op, torch_dtype


def _snapshot(op, scope, names):
    from ..io import _host_arrays
    vals = {}
    for name in names:
        v = scope.find_var(name)
        if v is None:
            raise RuntimeError(f"{op.type}: var {name!r} not in scope")
        vals[name] = v
    return _host_arrays(vals)


def _declared(op, name, arr):
    """Cast a loaded array to its var's declared dtype (fp16-saved params
    upcast on load), as the JAX ops do."""
    var = op.block.vars.get(name)
    if var is not None and var.dtype and str(arr.dtype) != var.dtype:
        arr = arr.astype(var.dtype)
    return arr


@register_host_op("save")
def _save(op, scope, feed, device):
    path = op.attrs["file_path"]
    if not op.attrs.get("overwrite", True) and os.path.exists(path):
        raise RuntimeError(f"save: {path!r} exists and overwrite=False")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    name = op.input("X")[0]
    arr = _snapshot(op, scope, [name])[name]
    if op.attrs.get("save_as_fp16", False):
        arr = arr.astype(np.float16)
    np.save(path, arr, allow_pickle=False)


@register_host_op("load")
def _load(op, scope, feed, device):
    path = op.attrs["file_path"]
    if not os.path.exists(path) and os.path.exists(path + ".npy"):
        path = path + ".npy"
    arr = np.load(path, allow_pickle=False)
    name = op.output("Out")[0]
    if op.attrs.get("load_as_fp16"):
        # reference load_op.cc: cast the loaded tensor to fp16 regardless
        # of the var's declared dtype
        arr = arr.astype(np.float16)
    else:
        arr = _declared(op, name, arr)
    scope.set_var(name, torch.from_numpy(np.ascontiguousarray(arr))
                  .to(device))


@register_host_op("save_combine")
def _save_combine(op, scope, feed, device):
    path = op.attrs["file_path"]
    if not op.attrs.get("overwrite", True) and os.path.exists(path):
        raise RuntimeError(f"save_combine: {path!r} exists")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = _snapshot(op, scope, op.input("X"))
    if op.attrs.get("save_as_fp16", False):
        arrays = {k: a.astype(np.float16) for k, a in arrays.items()}
    np.savez(path, **arrays)


@register_host_op("load_combine")
def _load_combine(op, scope, feed, device):
    path = op.attrs["file_path"]
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        for name in op.output("Out"):
            arr = _declared(op, name, z[name])
            scope.set_var(name, torch.from_numpy(np.ascontiguousarray(arr))
                          .to(device))


# ---------------------------------------------------------------------------
# trainer-side RPC ops over pskv
# ---------------------------------------------------------------------------

# (endpoint, trainer id) -> live KVClient
_CLIENTS = {}


def _client(endpoint, trainer_id=0):
    from ..distributed.pskv import KVClient
    key = (endpoint, trainer_id)
    if key not in _CLIENTS:
        host, port = endpoint.rsplit(":", 1)
        _CLIENTS[key] = KVClient(host, int(port), trainer_id=trainer_id)
    return _CLIENTS[key]


def close_clients() -> None:
    """Close every client the RPC ops opened in this process."""
    while _CLIENTS:
        _, c = _CLIENTS.popitem()
        c.close()


def _endpoints(op):
    eps = op.attrs.get("epmap") or op.attrs.get("endpoints") or []
    if isinstance(eps, str):
        eps = [eps]
    return eps


def _trainer_id(op):
    return int(op.attrs.get("trainer_id", 0))


@register_host_op("send")
def _send(op, scope, feed, device):
    """reference: distributed_ops/send_op.cc — push grads to pservers.
    Vars are pushed whole to each listed endpoint in round-robin over X
    (the reference's sliced send is a grpc detail; pskv shards by var). A
    SelectedRows goes as its rows and values."""
    from ..framework.selected_rows import SelectedRows
    from ..io import _host_arrays
    eps = _endpoints(op)
    names = op.input("X")
    flat = {}
    for name in names:
        v = scope.find_var(name)
        if v is None:
            raise RuntimeError(f"send: var {name!r} not in scope")
        if isinstance(v, SelectedRows):
            flat[name + "@rows"], flat[name] = v.rows, v.values
        else:
            flat[name] = v
    host = _host_arrays(flat)
    for i, name in enumerate(names):
        c = _client(eps[i % len(eps)], _trainer_id(op))
        if name + "@rows" in host:
            c.push_sparse(name, np.asarray(host[name + "@rows"], np.int64),
                          np.asarray(host[name], np.float32))
        else:
            c.push_dense(name, np.asarray(host[name], np.float32)
                         .reshape(-1))


@register_host_op("send_barrier")
def _send_barrier(op, scope, feed, device):
    for ep in _endpoints(op):
        _client(ep, _trainer_id(op)).barrier()


@register_host_op("fetch_barrier")
def _fetch_barrier(op, scope, feed, device):
    for ep in _endpoints(op):
        _client(ep, _trainer_id(op)).barrier()


@register_host_op("recv")
def _recv(op, scope, feed, device):
    """reference: distributed_ops/recv_op.cc — pull params from pservers
    onto the executor's device."""
    if int(op.attrs.get("do_not_run", 0)):
        return
    eps = _endpoints(op)
    for i, name in enumerate(op.output("Out")):
        var = op.block.vars.get(name)
        size = 1
        for d in (var.shape if var is not None and var.shape else [1]):
            size *= max(int(d), 1)
        c = _client(eps[i % len(eps)], _trainer_id(op))
        arr = c.pull_dense(name, size)
        if var is not None and var.shape:
            arr = arr.reshape([int(d) for d in var.shape])
        scope.set_var(name, torch.from_numpy(arr).to(device))


@register_host_op("prefetch")
def _prefetch(op, scope, feed, device):
    """reference: distributed_ops/prefetch_op.cc — pull only the embedding
    rows for this batch's ids from the remote sparse table, onto the
    executor's device."""
    eps = _endpoints(op)
    table = op.attrs.get("table_names", op.input("X"))
    if isinstance(table, str):
        table = [table]
    for i, (in_name, out_name) in enumerate(zip(op.input("X"),
                                                op.output("Out"))):
        ids_v = scope.find_var(in_name)
        if ids_v is None and in_name in feed:
            ids_v = feed[in_name]
        if isinstance(ids_v, torch.Tensor):
            ids_v = ids_v.cpu().numpy()
        ids = np.asarray(ids_v).reshape(-1).astype(np.int64)
        var = op.block.vars.get(out_name)
        dim = int(var.shape[-1]) if var is not None and var.shape else 1
        c = _client(eps[i % len(eps)], _trainer_id(op))
        vals = c.pull_sparse(table[i % len(table)], ids, dim)
        scope.set_var(out_name, torch.from_numpy(
            vals.reshape(len(ids), dim)).to(device))


@register_host_op("checkpoint_notify")
def _checkpoint_notify(op, scope, feed, device):
    """reference: distributed_ops/checkpoint_notify_op.cc — ask pservers
    to snapshot their shards."""
    path = op.attrs.get("dir", op.attrs.get("dirname", "ps_checkpoint"))
    for ep in _endpoints(op):
        _client(ep, _trainer_id(op)).save_checkpoint(path)


def _serve(op, sync):
    """Run a pskv server on the op's endpoint until a client sends
    shutdown."""
    import time
    from ..distributed.pskv import KVServer
    endpoint = op.attrs.get("endpoint", "127.0.0.1:0")
    port = int(endpoint.rsplit(":", 1)[1])
    fanin = int(op.attrs.get("Fanin", op.attrs.get("fanin", 1)))
    server = KVServer(port=port, trainers=max(fanin, 1), sync=sync)
    try:
        while not server.stopped():
            time.sleep(0.05)
    finally:
        server.stop()


@register_host_op("listen_and_serv")
def _listen_and_serv(op, scope, feed, device):
    """reference: distributed_ops/listen_and_serv_op.cc — the pserver
    loop: the pskv service, blocking until a client sends shutdown. The
    reference's per-request optimize sub-blocks are pskv's server-side
    optimizers."""
    _serve(op, bool(op.attrs.get("sync_mode", True)))


@register_host_op("fl_listen_and_serv")
def _fl_listen_and_serv(op, scope, feed, device):
    """reference: distributed_ops/fl_listen_and_serv_op.cc — federated
    variant: clients push at their own cadence, no barrier between
    trainers, which is pskv's async mode."""
    _serve(op, False)


@register_host_op("gen_nccl_id", aliases=("c_gen_nccl_id",))
def _gen_nccl_id(op, scope, feed, device):
    """reference: distributed_ops/gen_nccl_id_op.cc / collective/
    c_gen_nccl_id_op.cc — NCCL rendezvous bootstrap: a recorded no-op that
    writes an int32 zero, kept for program compatibility (as in JAX)."""
    for name in op.output_names():
        if name:
            scope.set_var(name, torch.zeros((1,), dtype=torch.int32,
                                            device=device))


# ---------------------------------------------------------------------------
# pure distributed compute ops
# ---------------------------------------------------------------------------

@register_op("fake_init", not_differentiable=True, grad_free=True)
def _fake_init(ctx, ins, attrs):
    """reference: distributed_ops/fake_init_op.cc — placeholder init for
    vars whose real values live on the pserver."""
    shape = [int(d) for d in attrs.get("shape", [1])]
    return {"Out": [torch.zeros(shape, dtype=torch_dtype(
        attrs.get("dtype", "float32")), device=ctx.device)]}


@register_op("split_byref", not_differentiable=True, grad_free=True)
def _split_byref(ctx, ins, attrs):
    """reference: distributed_ops/split_byref_op.cc — row-split a tensor
    into per-pserver sections."""
    x = ins["X"][0]
    sections = attrs.get("sections")
    if sections:
        outs, off = [], 0
        for s in sections:
            outs.append(x[off:off + int(s)])
            off += int(s)
        return {"Out": outs}
    num = int(attrs.get("num", 0) or 0)
    if x.shape[0] % num:
        raise ValueError(f"split_byref: {x.shape[0]} rows do not split "
                         f"into {num} equal sections")
    return {"Out": list(torch.split(x, x.shape[0] // num, dim=0))}


@register_op("split_ids", not_differentiable=True, grad_free=True)
def _split_ids(ctx, ins, attrs):
    """reference: distributed_ops/split_ids_op.cc — route ids to N shards
    by id % N. Fixed-size form, as JAX's: every shard output keeps the
    input length with non-member slots = -1 (consumers mask on >= 0)."""
    ids = ins["Ids"][0].reshape(-1)
    n = int(attrs.get("num", 0)) or len(attrs.get("endpoints", [])) or 1
    return {"Out": [torch.where(ids % n == shard, ids,
                                torch.full_like(ids, -1))
                    for shard in range(n)]}


@register_op("merge_ids", no_grad_inputs={"Ids", "Rows"})
def _merge_ids(ctx, ins, attrs):
    """reference: distributed_ops/merge_ids_op.cc — reassemble per-shard
    embedding lookups back into the original id order. Ids [m] original
    order; Rows = per-shard id lists (padded, -1 invalid); X = per-shard
    value matrices aligned with Rows. Each id takes the first matching
    row (a one-hot match, as JAX's)."""
    ids = ins["Ids"][0].reshape(-1)
    rows = torch.cat([r.reshape(-1) for r in ins["Rows"]])
    vals = torch.cat(list(ins["X"]), dim=0)
    hit = (ids[:, None] == rows[None, :]) & (rows[None, :] >= 0)
    idx = torch.argmax(hit.to(torch.int8), dim=1)
    return {"Out": [vals[idx]]}


@register_op("ref_by_trainer_id", no_grad_inputs={"TrainerId"})
def _ref_by_trainer_id(ctx, ins, attrs):
    """reference: distributed_ops/ref_by_trainer_id_op.cc — pick this
    trainer's slice from a duplicable input list (DC-ASGD)."""
    stacked = torch.stack(list(ins["X"]), dim=0)
    tid = ins["TrainerId"][0].reshape(1).long()
    return {"Out": [stacked.index_select(0, tid)[0]]}


@register_op("lookup_sparse_table", no_grad_inputs={"Ids"})
def _lookup_sparse_table(ctx, ins, attrs):
    """reference: lookup_sparse_table_op.cc — embedding lookup in a
    (possibly auto-growing) sparse table. Dense form, as JAX's: W is the
    dense [V, D] table (auto-growth is the pserver's; the distributed path
    pulls rows with the prefetch host op); out-of-range or padding ids
    return zero rows."""
    w = ins["W"][0]
    ids = ins["Ids"][0]
    flat = ids.reshape(-1)
    pad = int(attrs.get("padding_idx", -1))
    valid = (flat >= 0) & (flat < w.shape[0])
    if pad >= 0:
        valid &= (flat != pad)
    out = w[flat.clamp(0, w.shape[0] - 1)]
    out = torch.where(valid[:, None], out, torch.zeros_like(out))
    return {"Out": [out.reshape(tuple(ids.shape) + (w.shape[1],))]}
