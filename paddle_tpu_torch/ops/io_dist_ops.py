"""Host-boundary IO ops: save, load, save_combine, load_combine (reference:
save_op.cc, load_op.cc, save_combine_op.cc, load_combine_op.cc).

Port of the save/load part of `paddle_tpu/ops/io_dist_ops.py`: host ops
(registry.register_host_op) that the executor runs against the scope
outside the op sequence, a load in the prefix before the step and a save in
the suffix after it. The files are the JAX package's, byte for byte: `save`
writes one .npy per var (np.save), `save_combine` one .npz (np.savez), so a
file either package writes loads in the other. A save copies its tensors to
the host in one synchronised batch (io._host_arrays); a load places them on
the executor's device, in the var's declared dtype.

Not ported here: the RPC host ops (send, send_barrier, fetch_barrier,
recv, prefetch, checkpoint_notify, listen_and_serv, fl_listen_and_serv,
gen_nccl_id) and the parameter-server device ops (fake_init, split_byref,
split_ids, merge_ids, ref_by_trainer_id, lookup_sparse_table): they come
with the parameter server (ROADMAP A.9), and the executor raises on the
RPC ops by name.
"""

import os

import numpy as np
import torch

from ..framework.registry import register_host_op


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
