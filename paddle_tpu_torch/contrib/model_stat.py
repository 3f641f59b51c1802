"""Model PARAMs/FLOPs summary (reference:
python/paddle/fluid/contrib/model_stat.py:40 `summary(main_prog)`).
Port of `paddle_tpu/contrib/model_stat.py` (a copy).

Walks every block, counts parameters and forward FLOPs for the common op
families (conv, fc/mul, pool, activations, batch_norm), prints a table and
returns (rows, totals) so tools can consume it programmatically — the
reference only prints."""

from __future__ import annotations

from collections import OrderedDict

__all__ = ["summary"]


def _prod(xs):
    p = 1
    for x in xs:
        p *= abs(int(x))
    return p


def _op_stats(block_vars, op):
    """-> (in_shape, out_shape, params, flops) or None for uncounted ops."""
    def shape(name):
        v = block_vars.get(name)
        return tuple(v.shape) if v is not None and v.shape else ()

    if op.type in ("conv2d", "depthwise_conv2d"):
        w = shape(op.input("Filter")[0])
        out = shape(op.output("Output")[0])
        if len(w) != 4 or len(out) != 4:
            return None
        c_out, c_in, k_h, k_w = w
        h_out, w_out = out[2], out[3]
        groups = op.attrs.get("groups", 1) or 1
        kernel_ops = k_h * k_w * (c_in / groups)
        bias_ops = 1 if op.input("Bias") else 0
        params = c_out * (kernel_ops + bias_ops)
        flops = 2 * h_out * w_out * c_out * (kernel_ops + bias_ops)
        return shape(op.input("Input")[0]), out, params, flops

    if op.type == "pool2d":
        out = shape(op.output("Out")[0])
        if len(out) != 4:
            return None
        ksize = op.attrs.get("ksize", [1, 1])
        flops = out[1] * out[2] * out[3] * ksize[0] * ksize[1]
        return shape(op.input("X")[0]), out, 0, flops

    if op.type in ("mul", "matmul"):
        w = shape(op.input("Y")[0])
        if len(w) != 2:
            return None
        k_in, k_out = w
        return (shape(op.input("X")[0]), shape(op.output("Out")[0]),
                k_in * k_out + 1, 2 * k_in * k_out)

    if op.type in ("sigmoid", "tanh", "relu", "leaky_relu", "prelu"):
        in_shape = shape(op.input("X")[0])
        return (in_shape, shape(op.output("Out")[0]),
                1 if op.type == "prelu" else 0, _prod(in_shape))

    if op.type == "batch_norm":
        in_shape = shape(op.input("X")[0])
        if len(in_shape) < 2:
            return None
        c = in_shape[1]
        spatial = _prod(in_shape[2:]) if len(in_shape) > 2 else 1
        return (in_shape, shape(op.output("Y")[0]), c * 2, spatial * c * 2)

    return None


def summary(main_prog):
    """Print + return the per-op PARAMs/FLOPs table for a program."""
    rows = []
    for blk in main_prog.blocks:
        for op in blk.ops:
            if op.attrs.get("op_role") in ("backward", "optimize",
                                           "lr_sched"):
                continue
            res = _op_stats(blk.vars, op)
            if res is None:
                continue
            info = OrderedDict()
            info["type"] = op.type
            info["input_shape"] = res[0][1:]
            info["out_shape"] = res[1][1:]
            info["PARAMs"] = res[2]
            info["FLOPs"] = res[3]
            rows.append(info)

    total_params = sum(r["PARAMs"] for r in rows)
    total_flops = sum(r["FLOPs"] for r in rows)
    header = f"{'type':<18}{'input_shape':<22}{'out_shape':<22}" \
             f"{'PARAMs':>14}{'FLOPs':>16}"
    print(header)
    print("-" * len(header))
    for r in rows:
        print(f"{r['type']:<18}{str(r['input_shape']):<22}"
              f"{str(r['out_shape']):<22}{r['PARAMs']:>14.0f}"
              f"{r['FLOPs']:>16.0f}")
    print("-" * len(header))
    print(f"Total PARAMs: {total_params:.4e} ({total_params / 1e6:.4f}M)")
    print(f"Total FLOPs:  {total_flops:.4e} ({total_flops / 1e9:.2f}G)")
    return rows, {"PARAMs": total_params, "FLOPs": total_flops}
