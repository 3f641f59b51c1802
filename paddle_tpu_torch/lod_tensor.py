"""LoD-tensor helpers, copied from `paddle_tpu/lod_tensor.py` (numpy only;
reference: python/paddle/fluid/lod_tensor.py
create_lod_tensor / create_random_int_lodtensor; nested semantics from
framework/lod_tensor.h:104 `LoD = vector<vector<size_t>>` — level i's
offsets index the elements of level i+1, the last level indexes rows).

The representation of a ragged batch is (values, lod) — the same pair
the native datafeed emits — plus padded/static-shape views for the
executor's step.  A 1-level LoD is a flat offsets array; a nested LoD is a list of
offset arrays, arbitrarily deep like the reference's.  The padded view of a
2-level batch (doc→sentence→word) is a dense [docs, max_sents, max_words,
feat...] block plus per-level length tensors — fixed shapes, with masks
carrying the raggedness (SURVEY §7 "LoD/ragged via dense padding").
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["create_lod_tensor", "create_random_int_lodtensor",
           "lod_to_padded", "padded_to_lod",
           "convert_to_offset_based", "convert_to_length_based",
           "to_abs_offsets", "lod_to_nested_padded", "nested_padded_to_lod"]


def convert_to_offset_based(recursive_seq_lens) -> List[np.ndarray]:
    """Length-based LoD -> offset-based (reference ConvertToOffsetBasedLoD,
    lod_tensor.h:226: [[2, 1], [3, 2, 4]] -> [[0, 2, 3], [0, 3, 5, 9]])."""
    lod = []
    for lens in recursive_seq_lens:
        offs = np.zeros(len(lens) + 1, np.int64)
        offs[1:] = np.cumsum(lens)
        lod.append(offs)
    return lod


def convert_to_length_based(lod) -> List[List[int]]:
    """Offset-based LoD -> length-based (reference ConvertToLengthBasedLoD,
    lod_tensor.h:219)."""
    return [list(np.diff(np.asarray(level, np.int64))) for level in lod]


def _validate_lod(lod: Sequence[np.ndarray], n_rows: int) -> None:
    for i, level in enumerate(lod):
        level = np.asarray(level)
        if level[0] != 0 or np.any(np.diff(level) < 0):
            raise ValueError(f"LoD level {i} must start at 0 and be "
                             f"non-decreasing, got {level.tolist()}")
        limit = (len(lod[i + 1]) - 1) if i + 1 < len(lod) else n_rows
        if level[-1] != limit:
            raise ValueError(
                f"LoD level {i} ends at {level[-1]} but level "
                f"{'below has' if i + 1 < len(lod) else 'data has'} {limit} "
                f"{'elements' if i + 1 < len(lod) else 'rows'}")


def to_abs_offsets(lod) -> List[np.ndarray]:
    """Convert every level to absolute ROW offsets (reference ToAbsOffset,
    lod_tensor.cc: [[0,3,4,8],[0,9,10,11,13,17,19,22,24]] level 0 becomes
    [0, 11, 13, 24] — offsets into rows rather than into the next level)."""
    abs_lod = [np.asarray(level, np.int64) for level in lod]
    for i in range(len(abs_lod) - 2, -1, -1):
        abs_lod[i] = abs_lod[i + 1][abs_lod[i]]
    return abs_lod


def create_lod_tensor(data, recursive_seq_lens: Sequence[Sequence[int]],
                      place=None):
    """data: list-of-lists or flat ndarray; recursive_seq_lens is
    length-based, one entry per LoD level (outermost first, like the
    reference).  Returns (values, offsets-array) for one level — the
    historical fast path — or (values, [offsets...]) for nested LoD."""
    lod = convert_to_offset_based(recursive_seq_lens)
    if isinstance(data, np.ndarray):
        values = np.asarray(data)
    else:
        # keep per-element feature dims: each sequence contributes
        # len(seq) ROWS, not len(seq)*prod(feature) scalars
        rows = [np.asarray(seq) for seq in data]
        values = np.concatenate(rows) if rows else np.empty((0,))
    _validate_lod(lod, values.shape[0])
    if len(lod) == 1:
        return values, lod[0]
    return values, lod


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place,
                                low, high):
    lod = convert_to_offset_based(recursive_seq_lens)
    total = int(to_abs_offsets(lod)[0][-1])
    values = np.random.randint(low, high + 1,
                               (total,) + tuple(base_shape)).astype(np.int64)
    if len(lod) == 1:
        return values, lod[0]
    return values, lod


def lod_to_padded(values: np.ndarray, offsets, maxlen=None, pad_value=0,
                  level: int = -1):
    """(values, offsets) -> (padded [b, maxlen, ...], lengths [b]).

    `offsets` may be a flat array (1 level) or a nested LoD list; `level`
    picks which level's segments to pad over (absolute row offsets are used,
    so level=0 of a 2-level batch pads whole documents as flat runs of
    words)."""
    if isinstance(offsets, (list, tuple)) and not np.isscalar(offsets[0]):
        offsets = to_abs_offsets(offsets)[level]
    offsets = np.asarray(offsets, np.int64)
    lens = np.diff(offsets)
    b = len(lens)
    if maxlen is not None:
        t = int(maxlen)
    else:
        t = int(lens.max()) if b else 0
    out = np.full((b, t) + values.shape[1:], pad_value, values.dtype)
    for i in range(b):
        n = min(int(lens[i]), t)
        out[i, :n] = values[offsets[i]:offsets[i] + n]
    # truncated rows must report truncated lengths or the (padded, lens)
    # pair is internally inconsistent
    return out, np.minimum(lens, t).astype(np.int64)


def padded_to_lod(padded: np.ndarray, lengths: np.ndarray):
    """(padded, lengths) -> (values, offsets)."""
    parts = [padded[i, :int(n)] for i, n in enumerate(lengths)]
    values = np.concatenate(parts) if parts else \
        np.empty((0,) + padded.shape[2:], padded.dtype)
    offsets = np.zeros(len(lengths) + 1, np.int64)
    offsets[1:] = np.cumsum(lengths)
    return values, offsets


def lod_to_nested_padded(values: np.ndarray, lod, pad_value=0,
                         max_outer=None, max_inner=None):
    """2-level (values, lod) -> dense nested block for the executor's step.

    Returns (padded [n0, S1, S2, feat...], outer_lens [n0], inner_lens
    [n0, S1]): outer_lens[i] = sequences in element i (sentences per doc),
    inner_lens[i, j] = rows in its j-th sequence (words per sentence).
    This is the static-shape layout for doc→sentence→word batches; the
    sequence ops mask with the two length tensors (sequence_ops.py)."""
    if len(lod) != 2:
        raise ValueError(f"need a 2-level LoD, got {len(lod)} level(s)")
    outer, inner = (np.asarray(l, np.int64) for l in lod)
    _validate_lod([outer, inner], values.shape[0])
    outer_lens = np.diff(outer)
    inner_lens_flat = np.diff(inner)
    n0 = len(outer_lens)
    s1 = int(max_outer if max_outer is not None
             else (outer_lens.max() if n0 else 0))
    s2 = int(max_inner if max_inner is not None
             else (inner_lens_flat.max() if len(inner_lens_flat) else 0))
    padded = np.full((n0, s1, s2) + values.shape[1:], pad_value, values.dtype)
    inner_lens = np.zeros((n0, s1), np.int64)
    for i in range(n0):
        for jj, j in enumerate(range(outer[i], outer[i + 1])):
            if jj >= s1:
                break
            n = min(int(inner_lens_flat[j]), s2)
            padded[i, jj, :n] = values[inner[j]:inner[j] + n]
            inner_lens[i, jj] = n
    return padded, np.minimum(outer_lens, s1).astype(np.int64), inner_lens


def nested_padded_to_lod(padded: np.ndarray, outer_lens: np.ndarray,
                         inner_lens: np.ndarray):
    """Inverse of lod_to_nested_padded: -> (values, [outer, inner])."""
    parts = []
    outer = [0]
    inner = [0]
    for i in range(len(outer_lens)):
        k = int(outer_lens[i])
        outer.append(outer[-1] + k)
        for j in range(k):
            n = int(inner_lens[i, j])
            inner.append(inner[-1] + n)
            parts.append(padded[i, j, :n])
    values = np.concatenate(parts) if parts else \
        np.empty((0,) + padded.shape[3:], padded.dtype)
    return values, [np.asarray(outer, np.int64), np.asarray(inner, np.int64)]
