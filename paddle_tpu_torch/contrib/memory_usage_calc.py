"""Estimate a program's activation/parameter memory footprint
(reference: python/paddle/fluid/contrib/memory_usage_calc.py:46).

Port of `paddle_tpu/contrib/memory_usage_calc.py` (a copy).

Sums the byte size of every distinct op output in the global block (the
dense lod_tensor vars), expanding one -1 batch dim with the given batch
size, and returns (lower, upper, unit) with the reference's 5%-10% slack.
It is the upper bound of a run that keeps every value: the executor's
in-place updates of the persistables land under it."""

from __future__ import annotations

__all__ = ["memory_usage"]

_DTYPE_SIZE = {"bool": 1, "int8": 1, "uint8": 1, "int16": 2, "float16": 2,
               "bfloat16": 2, "int32": 4, "float32": 4, "int64": 8,
               "float64": 8}


def memory_usage(program, batch_size):
    from ..framework.core import Program

    if not isinstance(program, Program):
        raise TypeError(
            "Calculating Memory Usage requires Program as its Parameter. "
            f"But you passed in {type(program)}")
    if batch_size <= 0:
        raise ValueError("The batch size need to be positive.")

    blk = program.global_block
    total = 0.0
    seen = set()
    for op in blk.ops:
        for name in op.output_names():
            if name in seen:
                continue
            seen.add(name)
            var = blk.vars.get(name)
            if var is None or var.type != "lod_tensor" or var.shape is None:
                continue
            count = 1
            neg = 0
            for d in var.shape:
                if d < 0:
                    if neg >= 1:
                        raise ValueError(
                            f"Var {name} has more than one negative dim.")
                    neg += 1
                    count *= batch_size * (-d)
                else:
                    count *= d
            total += count * _DTYPE_SIZE.get(var.dtype, 4)

    unit = "B"
    if total > 1024:
        total /= 1024
        unit = "KB"
        if total > 1024:
            total /= 1024
            unit = "MB"
    return total * 1.05, total * 1.1, unit
