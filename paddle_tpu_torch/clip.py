"""Gradient clipping as IR rewrites (reference: python/paddle/fluid/clip.py).

A copy of `paddle_tpu/clip.py` (pure IR): each clip appends ops to the
program (clip, clip_by_norm, squared_l2_norm/sum/sqrt, elementwise_max/
div/mul, fill_constant), which the executor runs like any other.
GradientClipByGlobalNorm builds the global-norm reduction in-graph and
records its var as `program._global_norm_var`, which the training
telemetry tap reuses.
"""

from .framework.core import unique_name

__all__ = ["ErrorClipByValue", "GradientClipByValue",
           "GradientClipByNorm", "GradientClipByGlobalNorm"]


def append_global_norm_ops(block, params_grads, attrs=None, name="global"):
    """Append the in-graph global-norm reduction over `params_grads`
    (per-grad squared_l2_norm -> sum -> sqrt); returns the norm
    Variable. Shared by GradientClipByGlobalNorm and the training
    telemetry tap (observability/train_stats.py) so the clip norm and
    the surfaced telemetry norm cannot diverge."""
    attrs = dict(attrs or {})
    sq_names = []
    for _, g in params_grads:
        sq = block.create_var(name=unique_name(g.name + "@SQNORM"),
                              shape=(1,), dtype="float32")
        block.append_op("squared_l2_norm", {"X": [g.name]},
                        {"Out": [sq.name]}, dict(attrs),
                        infer_shape=False)
        sq_names.append(sq.name)
    total = block.create_var(name=unique_name(f"{name}_sqnorm"),
                             shape=(1,), dtype="float32")
    block.append_op("sum", {"X": sq_names}, {"Out": [total.name]},
                    dict(attrs), infer_shape=False)
    gnorm = block.create_var(name=unique_name(f"{name}_norm"), shape=(1,),
                             dtype="float32")
    block.append_op("sqrt", {"X": [total.name]}, {"Out": [gnorm.name]},
                    dict(attrs), infer_shape=False)
    return gnorm


class GradientClipByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            blk = g.block
            c = blk.create_var(name=unique_name(g.name + "@CLIP"),
                               shape=g.shape, dtype=g.dtype)
            blk.append_op("clip", {"X": [g.name]}, {"Out": [c.name]},
                          {"min": self.min, "max": self.max},
                          infer_shape=False)
            out.append((p, c))
        return out


class GradientClipByNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            blk = g.block
            c = blk.create_var(name=unique_name(g.name + "@CLIP"),
                               shape=g.shape, dtype=g.dtype)
            blk.append_op("clip_by_norm", {"X": [g.name]}, {"Out": [c.name]},
                          {"max_norm": self.clip_norm}, infer_shape=False)
            out.append((p, c))
        return out


class GradientClipByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        if not params_grads:
            return params_grads
        blk = params_grads[0][1].block
        gnorm = append_global_norm_ops(blk, params_grads)
        # Surface the already-computed norm instead of dropping it: the
        # training-telemetry tap (observability/train_stats.py) fetches
        # it per step, and callers can fetch_list it directly.
        self.last_global_norm_name = gnorm.name
        blk.program._global_norm_var = gnorm.name
        # scale = clip_norm / max(gnorm, clip_norm)
        maxed = blk.create_var(name=unique_name("global_norm_max"),
                               shape=(1,), dtype="float32")
        cn = blk.create_var(name=unique_name("clip_norm_const"), shape=(1,),
                            dtype="float32")
        blk.append_op("fill_constant", {}, {"Out": [cn.name]},
                      {"shape": [1], "dtype": "float32",
                       "value": self.clip_norm}, infer_shape=False)
        blk.append_op("elementwise_max", {"X": [gnorm.name], "Y": [cn.name]},
                      {"Out": [maxed.name]}, infer_shape=False)
        scale = blk.create_var(name=unique_name("clip_scale"), shape=(1,),
                               dtype="float32")
        blk.append_op("elementwise_div", {"X": [cn.name], "Y": [maxed.name]},
                      {"Out": [scale.name]}, infer_shape=False)
        out = []
        for p, g in params_grads:
            c = blk.create_var(name=unique_name(g.name + "@CLIP"),
                               shape=g.shape, dtype=g.dtype)
            blk.append_op("elementwise_mul",
                          {"X": [g.name], "Y": [scale.name]},
                          {"Out": [c.name]}, {"axis": -1}, infer_shape=False)
            out.append((p, c))
        return out


class ErrorClipByValue:
    """Clip the GRADIENT of a specific forward var (reference: clip.py
    ErrorClipByValue, attached via var.error_clip and applied by the
    backward pass as the grad for that var is produced).  Here the same
    contract: `append_clip_op` rewrites the grad var in place; callers
    (or backward callbacks) invoke it with the block + grad name."""

    def __init__(self, max, min=None):
        max = float(max)
        if min is None:
            min = -max
        else:
            min = float(min)
        self.max = max
        self.min = min

    def __str__(self):
        return f"ByValue, min={self.min}, max={self.max}"

    def _append_clip_op(self, block, grad_name):
        block.append_op("clip", {"X": [grad_name]}, {"Out": [grad_name]},
                        {"min": self.min, "max": self.max},
                        infer_shape=False)

    append_clip_op = _append_clip_op
