"""SelectedRows: the sparse row-slice value of an embedding's gradient.

Port of `paddle_tpu/framework/selected_rows.py` (reference:
paddle/fluid/framework/selected_rows.h:32): a {rows, values, height}
triple standing for a tall tensor whose only non-zero rows are `rows`.
`lookup_table_grad` with is_sparse=True makes one; the sum, scale, clip
and elementwise ops keep it sparse where the JAX rules do, and the sparse
branches of the optimizer ops consume it.

As in JAX, `rows` keeps its static length (the batch's ids, duplicates
in place; nothing is uniquified, so nothing waits on the host for a
count):
  * scatter-ADD consumers (sgd, sum) take duplicates as they are;
  * read-modify-write consumers (adam, adagrad, momentum) first merge
    them with `merge_rows`, so every occurrence of a row carries the
    row's whole value and a scatter-SET writes it once, whichever
    occurrence lands last.

Every scatter-add here is `index_put_(..., accumulate=True)`: it adds an
index's values in their order on the CPU and, on CUDA, through PyTorch's
sort-based accumulate kernel, with no atomics, so a rerun gives the same
bits (the optimizers' donated and out-of-place updates too).
"""

from __future__ import annotations

import torch

__all__ = ["SelectedRows", "merge_rows", "row_mask", "to_dense",
           "scatter_add"]


def scatter_add(dense: torch.Tensor, rows: torch.Tensor,
                values: torch.Tensor, inplace: bool = False):
    """dense with values[i] added into row rows[i], duplicates summed in
    order (JAX's `dense.at[rows].add(values)`); written into `dense` when
    `inplace`."""
    if inplace:
        return dense.index_put_((rows,), values, accumulate=True)
    return dense.index_put((rows,), values, accumulate=True)


class SelectedRows:
    """rows: int tensor [n]; values: [n, d...]; height: the table's row
    count."""

    def __init__(self, rows, values, height: int):
        self.rows = rows
        self.values = values
        self.height = int(height)

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    def to_dense(self):
        dense = torch.zeros(self.shape, dtype=self.values.dtype,
                            device=self.values.device)
        return scatter_add(dense, self.rows, self.values, inplace=True)

    def astype(self, dtype):
        return SelectedRows(self.rows, self.values.to(dtype), self.height)

    def __repr__(self):
        return (f"SelectedRows(n={self.rows.shape[0]}, height={self.height}, "
                f"dim={tuple(self.values.shape[1:])})")


def to_dense(x):
    return x.to_dense() if isinstance(x, SelectedRows) else x


def merge_rows(sr: SelectedRows) -> SelectedRows:
    """Sum the values of duplicate rows so that every occurrence of a row
    carries the row's merged value (reference: operators/math/
    selected_rows_functor.cc MergeAdd), keeping the static length. As in
    JAX, the sums gather into one [height, d...] buffer (in at least f32)
    and are read back at `rows`."""
    acc = torch.promote_types(sr.values.dtype, torch.float32)
    dense = torch.zeros((sr.height,) + tuple(sr.values.shape[1:]),
                        dtype=acc, device=sr.values.device)
    dense = scatter_add(dense, sr.rows, sr.values.to(acc), inplace=True)
    return SelectedRows(sr.rows, dense[sr.rows].to(sr.values.dtype),
                        sr.height)


def row_mask(sr: SelectedRows) -> torch.Tensor:
    """[n] bool mask that is True for exactly one occurrence of each row
    (the first in a stable sort of the rows), so per-row terms count once
    under duplicates."""
    order = torch.argsort(sr.rows, stable=True)
    sorted_rows = sr.rows[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool,
                                  device=sorted_rows.device),
                       sorted_rows[1:] != sorted_rows[:-1]])
    return torch.zeros_like(first).scatter(0, order, first)
