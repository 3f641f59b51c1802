"""DataFeeder: convert per-sample python data into batched feed dicts.

Reference: python/paddle/fluid/data_feeder.py — DataFeeder(feed_list,
place).feed(minibatch) returns {var name: LoDTensor}; here the values are
numpy arrays shaped to the feed vars (batch dim prepended, ragged int
sequences padded to the var's static width). A copy of
`paddle_tpu/data_feeder.py`; given a `place` (`CPUPlace()` or
`CUDAPlace(i)`), `feed` returns torch tensors on that place instead, as the
reference's LoDTensors live on theirs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .framework.core import Variable

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None, program=None):
        self.place = place
        self.feed_vars: List[Variable] = [
            v if isinstance(v, Variable) else
            (program or _default()).global_block.var(v)
            for v in feed_list]

    def feed(self, iterable) -> Dict[str, np.ndarray]:
        """iterable: list of samples, each a tuple matching feed_list."""
        samples = list(iterable)
        out: Dict[str, np.ndarray] = {}
        for i, var in enumerate(self.feed_vars):
            cols = [s[i] for s in samples]
            width = 1
            for d in (var.shape[1:] if var.shape else ()):
                width *= int(d)
            arrs = []
            for c in cols:
                a = np.asarray(c)
                flat = a.reshape(-1)
                if flat.size == width:
                    arrs.append(flat)
                elif flat.size < width and np.issubdtype(
                        np.dtype(var.dtype), np.integer):
                    # ragged ID sequences pad with 0; short FLOAT data is
                    # a shape bug, not raggedness — fall through to raise
                    pad = np.zeros(width, flat.dtype)
                    pad[:flat.size] = flat
                    arrs.append(pad)
                else:
                    raise ValueError(
                        f"sample for {var.name!r} has {flat.size} values "
                        f"but the feed var holds {width}; over-long data "
                        "is a shape mismatch, not a ragged sequence")
            batch = np.stack(arrs).reshape(
                (len(samples),) + tuple(var.shape[1:]))
            out[var.name] = batch.astype(var.dtype, copy=False)
        if self.place is not None:
            import torch
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.place.device) for k, v in out.items()}
        return out


def _default():
    from .framework.core import default_main_program
    return default_main_program()
