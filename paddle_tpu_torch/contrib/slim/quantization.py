"""Quantization-aware training passes over the Program IR.

Port of `paddle_tpu/contrib/slim/quantization.py`: the same passes, with
the scope's values as torch tensors. The freeze pass and post-training
quantization snap weights and take histograms in numpy on the host, as
the JAX package does, and put the snapped weights back on the device the
scope held them on.

Reference: python/paddle/fluid/contrib/slim/quantization/quantization_pass.py
— `QuantizationTransformPass` (:41) inserts fake_quantize/dequantize pairs
on the weights and activations of quantizable ops in the IrGraph;
`QuantizationFreezePass` bakes trained scales in for inference export.

Differences from the reference, by design: the pass runs on the Program
(our IR) BEFORE minimize()/append_backward — gradients of the fake-quant
ops then come from their registered STE rules automatically, instead of
the reference's hand-inserted grad-op rewiring.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

import torch

from ...framework.core import Operator, Parameter, Program, unique_name
from ...framework.executor import _to_numpy

__all__ = ["QuantizationTransformPass", "QuantizationFreezePass",
           "PostTrainingQuantization"]

# op type -> (activation input slot, weight input slot, weight quant axis)
_QUANTIZABLE = {
    "conv2d": ("Input", "Filter", 0),
    "conv2d_transpose": ("Input", "Filter", 0),
    "mul": ("X", "Y", 1),
    "matmul": ("X", "Y", 1),
}


def _host(value) -> np.ndarray:
    """A scope value as a float32 host array (a copy)."""
    return np.asarray(_to_numpy(value), np.float32)


def _to_scope(arr: np.ndarray, like) -> torch.Tensor:
    """`arr` as a tensor on the device of the scope value it replaces."""
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


class QuantizationTransformPass:
    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 activation_quantize_type: str = "moving_average_abs_max",
                 weight_quantize_type: str = "channel_wise_abs_max",
                 moving_rate: float = 0.9,
                 quantizable_op_type: Optional[Sequence[str]] = None,
                 skip_pattern: str = "skip_quant"):
        if activation_quantize_type not in ("moving_average_abs_max",
                                            "abs_max"):
            raise ValueError(activation_quantize_type)
        if weight_quantize_type not in ("channel_wise_abs_max", "abs_max"):
            raise ValueError(weight_quantize_type)
        self.wbits = weight_bits
        self.abits = activation_bits
        self.act_type = activation_quantize_type
        self.w_type = weight_quantize_type
        self.moving_rate = moving_rate
        self.op_types = list(quantizable_op_type or _QUANTIZABLE)
        self.skip_pattern = skip_pattern

    def apply(self, program: Program, startup: Program) -> None:
        """In place. Call BEFORE optimizer.minimize() so backward picks up
        the STE grads of the inserted fake ops."""
        blk = program.global_block
        if any(op.attrs.get("op_role") == "backward" for op in blk.ops):
            raise RuntimeError(
                "QuantizationTransformPass must run before "
                "append_backward/minimize")
        quantized: Dict[str, str] = {}  # original var -> quantized var
        i = 0
        while i < len(blk.ops):
            op = blk.ops[i]
            spec = _QUANTIZABLE.get(op.type)
            if spec is None or op.type not in self.op_types or \
                    self.skip_pattern in str(op.attrs.get("name", "")):
                i += 1
                continue
            act_slot, w_slot, w_axis = spec
            for slot, is_weight in ((act_slot, False), (w_slot, True)):
                names = op.inputs.get(slot)
                if not names:
                    continue
                src = names[0]
                var = blk.var(src)
                if is_weight and not isinstance(var, Parameter):
                    continue  # e.g. matmul of two activations
                key = (src, is_weight)
                if key in quantized:
                    op.inputs[slot] = [quantized[key]]
                    continue
                qname = unique_name(src + ".quantized")
                blk.create_var(name=qname, shape=var.shape, dtype=var.dtype)
                scale_name = unique_name(src + ".quant_scale")
                ins = {"X": [src]}
                if is_weight:
                    if self.w_type == "channel_wise_abs_max":
                        op_type = ("fake_channel_wise_quantize_dequantize"
                                   "_abs_max")
                        attrs = {"bit_length": self.wbits,
                                 "quant_axis": w_axis}
                        n_scale = var.shape[w_axis]
                    else:
                        op_type = "fake_quantize_dequantize_abs_max"
                        attrs = {"bit_length": self.wbits}
                        n_scale = 1
                    blk.create_var(name=scale_name,
                                   shape=(n_scale,), dtype="float32")
                elif self.act_type == "moving_average_abs_max":
                    op_type = ("fake_quantize_dequantize_moving_average"
                               "_abs_max")
                    attrs = {"bit_length": self.abits,
                             "moving_rate": self.moving_rate}
                    state = unique_name(src + ".quant_state")
                    blk.create_var(name=state, shape=(1,), dtype="float32",
                                   persistable=True, stop_gradient=True)
                    sb = startup.global_block
                    sb.create_var(name=state, shape=(1,), dtype="float32",
                                  persistable=True, stop_gradient=True)
                    sb.append_op("fill_constant", {}, {"Out": [state]},
                                 {"shape": [1], "dtype": "float32",
                                  "value": 0.0}, infer_shape=False)
                    ins["InScale"] = [state]
                else:
                    op_type = "fake_quantize_dequantize_abs_max"
                    attrs = {"bit_length": self.abits}
                    blk.create_var(name=scale_name, shape=(1,),
                                   dtype="float32")
                outs = {"Out": [qname], "OutScale": [scale_name]}
                if "InScale" in ins:
                    # write the state var so the moving average persists
                    outs["OutScale"] = [ins["InScale"][0]]
                qop = Operator(blk, op_type, ins, outs, attrs)
                blk.ops.insert(i, qop)
                i += 1
                op.inputs[slot] = [qname]
                quantized[key] = qname
            i += 1
        program._bump_version()


class QuantizationFreezePass:
    """Bake trained quantization in for inference: weights in the scope are
    snapped onto their int-b grid (values become exact multiples of
    scale/qmax), weight fake-ops are removed (the weight IS quantized now),
    and activation fake-ops flip to is_test (frozen moving scale). Returns
    {weight name: scale array} for export metadata."""

    def __init__(self, weight_bits: int = 8):
        self.wbits = weight_bits

    def apply(self, program: Program, scope) -> Dict[str, np.ndarray]:
        blk = program.global_block
        qmax = float(2 ** (self.wbits - 1) - 1)
        scales: Dict[str, np.ndarray] = {}
        keep = []
        rewire: Dict[str, str] = {}
        for op in blk.ops:
            if op.type in ("fake_quantize_dequantize_abs_max",
                           "fake_channel_wise_quantize_dequantize_abs_max"):
                src = op.inputs["X"][0]
                var = blk.var(src)
                if isinstance(var, Parameter):
                    old = scope.find_var(src)
                    w = _host(old)
                    axis = op.attrs.get("quant_axis", 0)
                    if op.type.startswith("fake_channel"):
                        red = tuple(i for i in range(w.ndim) if i != axis)
                        scale = np.max(np.abs(w), axis=red, keepdims=True)
                    else:
                        scale = np.max(np.abs(w))
                    safe = np.where(scale > 0, scale, 1.0)
                    q = np.clip(np.round(w * (qmax / safe)), -qmax, qmax)
                    scope.set_var(src, _to_scope(q * (safe / qmax), old))
                    scales[src] = np.ravel(scale)
                    rewire[op.outputs["Out"][0]] = src
                    continue  # drop the op
            if op.type == ("fake_quantize_dequantize_moving_average"
                           "_abs_max"):
                op.attrs["is_test"] = True
            keep.append(op)
        for op in keep:
            for slot, names in op.inputs.items():
                op.inputs[slot] = [rewire.get(n, n) for n in names]
        blk.ops = keep
        program._quant_weight_scales = scales
        program._bump_version()
        return scales


class PostTrainingQuantization:
    """Post-training int8 quantization: calibrate activation thresholds
    over a calibration reader, snap weights onto the channel-wise int8
    grid, and emit an inference program whose quantizable ops run through
    real int8 quantize/dequantize round trips.

    Reference: the int8 calibration flow under
    python/paddle/fluid/contrib/ (int8_inference README + the
    quantization passes); algo='abs_max' uses the max |x| seen during
    calibration, algo='KL' picks the KL-divergence-minimizing threshold
    (the TensorRT-style histogram method).
    """

    def __init__(self, executor, program: Program, feed_names,
                 fetch_targets, scope=None, algo: str = "abs_max",
                 weight_bits: int = 8, activation_bits: int = 8,
                 quantizable_op_type: Optional[Sequence[str]] = None):
        if algo not in ("abs_max", "KL"):
            raise ValueError(f"algo must be abs_max or KL, got {algo!r}")
        self.exe = executor
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_targets = list(fetch_targets)
        self.scope = scope
        self.algo = algo
        self.wbits = weight_bits
        self.abits = activation_bits
        self.op_types = list(quantizable_op_type or _QUANTIZABLE)

    # -- calibration --------------------------------------------------------

    def _quant_sites(self, blk):
        """(op index, activation var) pairs needing an input scale, plus
        the weight params to snap."""
        acts, weights = [], []
        for i, op in enumerate(blk.ops):
            spec = _QUANTIZABLE.get(op.type)
            if spec is None or op.type not in self.op_types:
                continue
            act_slot, w_slot, w_axis = spec
            a = op.inputs.get(act_slot)
            w = op.inputs.get(w_slot)
            if not a or not w:
                continue
            if not isinstance(blk.var(w[0]), Parameter):
                continue
            acts.append((i, a[0]))
            weights.append((w[0], w_axis))
        return acts, weights

    @staticmethod
    def _kl_threshold(hist, edges, quant_bins=128):
        """KL-minimizing saturation threshold over an |x| histogram."""
        total = hist.sum()
        if total == 0:
            return float(edges[-1])
        best_t, best_kl = float(edges[-1]), np.inf
        n = len(hist)
        for cut in range(quant_bins, n + 1, max(1, (n - quant_bins) // 32
                                                or 1)):
            sliced = hist[:cut].astype(np.float64)
            # p carries the clipped tail mass in its last bin; q is built
            # from the UNspiked slice (as in the TensorRT/MXNet method) —
            # folding the tail into q too would make every cut score
            # KL=0 at cut==quant_bins and select absurdly small
            # thresholds for unclipped distributions
            p = sliced.copy()
            p[-1] += hist[cut:].sum()
            if p.sum() == 0:
                continue
            factor = cut / quant_bins
            q = np.zeros(cut)
            for b in range(quant_bins):
                lo, hi = int(b * factor), max(int((b + 1) * factor),
                                              int(b * factor) + 1)
                chunk = sliced[lo:hi]
                nz = (chunk > 0).sum()
                if nz:
                    q[lo:hi] = np.where(chunk > 0, chunk.sum() / nz, 0)
            pn = p / p.sum()
            qn = q / q.sum() if q.sum() > 0 else q
            mask = pn > 0
            kl = np.sum(pn[mask] * np.log(
                pn[mask] / np.maximum(qn[mask], 1e-12)))
            if kl < best_kl:
                best_kl, best_t = kl, float(edges[cut - 1])
        return best_t

    def quantize(self, calibration_feeds) -> Program:
        """calibration_feeds: iterable of feed dicts. Returns the
        quantized inference program (weights in `scope` are snapped in
        place)."""
        from ...framework.executor import global_scope
        scope = self.scope or global_scope()
        infer = self.program.clone(for_test=True)
        blk = infer.global_block
        acts, weights = self._quant_sites(blk)
        act_names = sorted({name for _, name in acts})

        # 1. calibration. Two passes for KL: pass one fixes each var's
        # histogram range at its global abs-max (accumulating histograms
        # over batch-local, growing ranges would mix incompatible
        # binnings and skew the thresholds).
        calibration_feeds = list(calibration_feeds)
        maxima = {n: 0.0 for n in act_names}
        for feed in calibration_feeds:
            vals = self.exe.run(infer, feed=feed, fetch_list=act_names,
                                scope=scope)
            for n, v in zip(act_names, vals):
                v = np.abs(np.asarray(v, np.float32))
                maxima[n] = max(maxima[n], float(v.max(initial=0.0)))

        thresholds = {n: (maxima[n] if maxima[n] > 0 else 1.0)
                      for n in act_names}
        if self.algo == "KL":
            n_bins = 2048
            hists = {n: np.zeros(n_bins, np.int64) for n in act_names}
            for feed in calibration_feeds:
                vals = self.exe.run(infer, feed=feed,
                                    fetch_list=act_names, scope=scope)
                for n, v in zip(act_names, vals):
                    v = np.abs(np.asarray(v, np.float32)).ravel()
                    h, _ = np.histogram(
                        v, bins=n_bins, range=(0.0, maxima[n] + 1e-9))
                    hists[n] += h
            for n in act_names:
                if maxima[n] > 0:
                    edges = np.linspace(0.0, maxima[n], n_bins + 1)[1:]
                    thresholds[n] = self._kl_threshold(hists[n], edges)

        # 2. snap weights to the channel-wise int8 grid
        qmax_w = float(2 ** (self.wbits - 1) - 1)
        wscales = {}
        for wname, axis in weights:
            old = scope.find_var(wname)
            w = _host(old)
            red = tuple(i for i in range(w.ndim) if i != axis)
            scale = np.max(np.abs(w), axis=red, keepdims=True)
            safe = np.where(scale > 0, scale, 1.0)
            q = np.clip(np.round(w * (qmax_w / safe)), -qmax_w, qmax_w)
            scope.set_var(wname, _to_scope(q * (safe / qmax_w), old))
            wscales[wname] = np.ravel(scale)

        # 3. rewrite: int8 quantize -> dequantize round trip on each
        # quantizable op's activation input (fixed calibrated scale)
        qmax_a = float(2 ** (self.abits - 1) - 1)
        new_ops = []
        done = {}
        for i, op in enumerate(blk.ops):
            site = [a for a in acts if a[0] == i]
            if site:
                _, src = site[0]
                if src not in done:
                    t = thresholds[src]
                    qv = blk.create_var(
                        name=unique_name(f"{src}.int8"), dtype="int8",
                        shape=blk.var(src).shape)
                    dv = blk.create_var(
                        name=unique_name(f"{src}.dq"), dtype="float32",
                        shape=blk.var(src).shape)
                    q_op = type(op)(blk, "quantize", {"Input": [src]},
                                    {"Output": [qv.name]},
                                    {"Scale": qmax_a / t,
                                     "qmax": qmax_a})
                    d_op = type(op)(blk, "dequantize",
                                    {"Input": [qv.name]},
                                    {"Output": [dv.name]},
                                    {"Scale": qmax_a / t})
                    new_ops.extend([q_op, d_op])
                    done[src] = dv.name
                spec = _QUANTIZABLE[op.type]
                names = op.inputs[spec[0]]
                op.inputs[spec[0]] = [done.get(n, n) for n in names]
            new_ops.append(op)
        blk.ops = new_ops
        infer._bump_version()
        infer._quant_weight_scales = wscales
        infer._quant_act_thresholds = dict(thresholds)
        return infer
