"""Quantization ops (reference: paddle/fluid/operators/fake_quantize_op.cc).

Port of `paddle_tpu/ops/quant_ops.py`. Quantize-dequantize simulation for
QAT: the forward snaps values onto the int-b grid, the backward is the
straight-through estimator (clipped identity). Each rule is the JAX
rule's torch ops in the same order. Every division is an IEEE division by
a tensor on the input's device: on CUDA a tensor divided by a Python
number (or a CPU scalar) is a product with the number's rounded
reciprocal, which moves codes at the .5 ties `round` decides
(`torch.round` and `jnp.round` both round half to even).
"""

import torch

from ..framework.registry import register_op


def _qmax(bits):
    return float(2 ** (int(bits) - 1) - 1)


def _const(v, like):
    """The Python number `v` as a 0-d tensor of `like`'s dtype and device,
    so that a division by or of it is an IEEE division."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _quant_dequant(x, scale, qmax):
    qm = _const(qmax, scale)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x * (qm / safe)), -qmax, qmax)
    return torch.where(scale > 0, q * (safe / qm), x)


def _ste_grad(ctx, ins, attrs):
    """Straight-through: pass the out-grad through, zeroed where the
    forward clipped (reference fake_quantize_op grad kernels). Only a
    per-tensor (0-d) scale masks: channel-wise weights get no mask."""
    og = ins["Out@GRAD"][0]
    x = ins["X"][0]
    scale = ins["__out__OutScale"][0] if "__out__OutScale" in ins else None
    if scale is not None and scale.ndim == 0:
        mask = torch.abs(x) <= torch.where(
            scale > 0, scale, torch.full_like(scale, float("inf")))
        og = og * mask.to(og.dtype)
    return {"X@GRAD": [og]}


@register_op("fake_quantize_dequantize_abs_max", grad_lower=_ste_grad)
def _fake_qdq_abs_max(ctx, ins, attrs):
    """Per-tensor dynamic abs-max (reference FakeQuantizeDequantizeAbsMax).
    The scale is recomputed from the live tensor each step, so nothing
    ever clips: the STE is an exact identity."""
    x = ins["X"][0]
    qmax = _qmax(attrs.get("bit_length", 8))
    scale = torch.amax(torch.abs(x))
    return {"Out": [_quant_dequant(x, scale, qmax)],
            "OutScale": [scale.reshape(())]}


@register_op("fake_channel_wise_quantize_dequantize_abs_max",
             grad_lower=_ste_grad)
def _fake_qdq_channel(ctx, ins, attrs):
    """Per-channel abs-max for weights (reference
    FakeChannelWiseQuantizeDequantizeAbsMax); quant_axis 0 for conv
    filters [oc, ic, h, w], 1 for mul weights [in, out]."""
    x = ins["X"][0]
    qmax = _qmax(attrs.get("bit_length", 8))
    axis = attrs.get("quant_axis", 0)
    red = tuple(i for i in range(x.ndim) if i != axis)
    scale = torch.amax(torch.abs(x), dim=red, keepdim=True)
    out = _quant_dequant(x, scale, qmax)
    return {"Out": [out], "OutScale": [scale.reshape(-1)]}


@register_op("fake_quantize_dequantize_moving_average_abs_max",
             grad_lower=_ste_grad)
def _fake_qdq_moving(ctx, ins, attrs):
    """Activation quant with a moving-average scale held in a persistable
    state var (reference FakeQuantizeMovingAverageAbsMax). Training
    updates the scale and clips to it; inference uses the stored scale.
    The QAT pass binds OutScale to the InScale var, so the executor
    writes the new scale back into the scope."""
    x = ins["X"][0]
    in_scale = ins["InScale"][0].reshape(())
    qmax = _qmax(attrs.get("bit_length", 8))
    rho = attrs.get("moving_rate", 0.9)
    if attrs.get("is_test", False) or getattr(ctx, "is_test", False):
        scale = in_scale
    else:
        cur = torch.amax(torch.abs(x))
        scale = torch.where(in_scale > 0,
                            rho * in_scale + (1 - rho) * cur, cur)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    clipped = torch.minimum(torch.maximum(x, -safe), safe)
    out = _quant_dequant(clipped, scale, qmax)
    return {"Out": [out], "OutScale": [scale.reshape(())]}


@register_op("quantize_abs_max", not_differentiable=True, grad_free=True)
def _quantize_abs_max(ctx, ins, attrs):
    """Real int8 quantization for the freeze/export path."""
    x = ins["X"][0]
    qmax = _qmax(attrs.get("bit_length", 8))
    scale = torch.amax(torch.abs(x))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x * (_const(qmax, safe) / safe)),
                    -qmax, qmax)
    return {"Out": [q.to(torch.int8)], "OutScale": [scale.reshape(())]}


@register_op("dequantize_abs_max", not_differentiable=True, grad_free=True)
def _dequantize_abs_max(ctx, ins, attrs):
    x = ins["X"][0]
    scale = ins["Scale"][0].reshape(())
    qmax = _qmax(attrs.get("bit_length", 8))
    return {"Out": [x.to(torch.float32) * (scale / _const(qmax, scale))]}


@register_op("fake_dequantize_max_abs", not_differentiable=True,
             grad_free=True)
def _fake_dequantize_max_abs(ctx, ins, attrs):
    """reference: fake_dequantize_op.cc: Out = X * Scale / max_range."""
    x = ins["X"][0].to(torch.float32)
    scale = ins["Scale"][0].reshape(())
    rng = _const(float(attrs.get("max_range", 127.0)), x)
    return {"Out": [x * scale / rng]}


@register_op("fake_channel_wise_dequantize_max_abs",
             not_differentiable=True, grad_free=True)
def _fake_channel_wise_dequantize_max_abs(ctx, ins, attrs):
    """Per-output-channel variant: Scales is a list of scale tensors
    multiplied in order, each divided by its quant_bits range."""
    x = ins["X"][0].to(torch.float32)
    scales = ins["Scales"]
    bits = [int(b) for b in attrs.get("quant_bits", [8])]
    # a short quant_bits attr must not silently drop scale tensors
    bits += [8] * (len(scales) - len(bits))
    out = x
    for s, b in zip(scales, bits):
        rng = _const(float((1 << (b - 1)) - 1), x)
        s = s.reshape((-1,) + (1,) * (x.ndim - 1)) if s.numel() > 1 else \
            s.reshape(())
        out = out * s / rng
    return {"Out": [out]}
