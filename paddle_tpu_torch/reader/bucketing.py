"""Padding-bucket policy for ragged streams, copied from
`paddle_tpu/reader/bucketing.py` (numpy only).

SURVEY §7 hard part (b): variable-length batches hit the executor's
shape-keyed compile cache (framework/executor.py) once per distinct shape —
an unbounded stream of raw lengths means unbounded cache entries. The
reference tolerates true ragged shapes because LoD kernels are
shape-polymorphic (lod_tensor.h, operators/reader/buffered_reader.cc); the
answer here is to quantize the ragged axis to a small set of bucket widths
so the cache converges: compile count <= number of buckets.

Use `bucketed(reader, slots=[0], lengths_slot=1)` around any batch reader
(Executor feeds), or call `pad_to_bucket` directly when assembling feeds by
hand.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

__all__ = ["pow2_boundaries", "bucket_for", "pad_to_bucket", "bucketed"]


def pow2_boundaries(min_len: int = 8, max_len: int = 1024) -> List[int]:
    """Powers-of-two bucket widths: [8, 16, ..., max_len] (max_len included
    even when not a power of two, as the final catch-all)."""
    out = []
    b = max(1, int(min_len))
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(int(max_len))
    return out


def bucket_for(length: int, boundaries: Sequence[int]) -> int:
    """Smallest boundary >= length (the last boundary if none is)."""
    for b in boundaries:
        if length <= b:
            return int(b)
    return int(boundaries[-1])


def pad_to_bucket(array: np.ndarray, boundaries: Sequence[int],
                  axis: int = 1, pad_value=0) -> np.ndarray:
    """Pad (or truncate, if beyond the last boundary) `axis` to its bucket
    width. A batch whose max length is 37 becomes width-64 under pow2
    buckets — every 33..64-length batch then shares one executable."""
    length = array.shape[axis]
    target = bucket_for(length, boundaries)
    if target == length:
        return array
    if target < length:  # beyond the catch-all: truncate (documented policy)
        sl = [slice(None)] * array.ndim
        sl[axis] = slice(0, target)
        return array[tuple(sl)]
    pad = [(0, 0)] * array.ndim
    pad[axis] = (0, target - length)
    return np.pad(array, pad, constant_values=pad_value)


def bucketed(reader, slots: Union[Sequence[int], Sequence[str]],
             boundaries: Optional[Sequence[int]] = None, axis: int = 1,
             pad_value=0, lengths_slot: Union[int, str, None] = None):
    """Decorate a batch reader so ragged slots snap to bucket widths.

    reader() yields batches as tuples/lists (slots = indices) or dicts
    (slots = keys).  `lengths_slot` names an optional per-row lengths entry
    clipped to the bucket width so (padded, lengths) stays consistent when
    the catch-all truncates.  Default boundaries: pow2 up to 1024."""
    bounds = list(boundaries) if boundaries is not None \
        else pow2_boundaries()

    def _clip(lens, width):
        return np.minimum(np.asarray(lens), width)

    def wrapped():
        for batch in reader():
            if isinstance(batch, dict):
                out = dict(batch)
                width = None
                for k in slots:
                    out[k] = pad_to_bucket(np.asarray(batch[k]), bounds,
                                           axis, pad_value)
                    width = out[k].shape[axis]
                if lengths_slot is not None and width is not None:
                    out[lengths_slot] = _clip(batch[lengths_slot], width)
                yield out
            else:
                out = list(batch)
                width = None
                for i in slots:
                    out[i] = pad_to_bucket(np.asarray(batch[i]), bounds,
                                           axis, pad_value)
                    width = out[i].shape[axis]
                if lengths_slot is not None and width is not None:
                    out[lengths_slot] = _clip(batch[lengths_slot], width)
                yield tuple(out)
    return wrapped
