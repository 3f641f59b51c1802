"""Magnitude pruning (reference: contrib/slim/prune/pruner.py Pruner —
structured filter pruning by L1 norm, plus unstructured ratio pruning).

Port of `paddle_tpu/contrib/slim/prune.py`: masks are chosen in numpy on
the host, as in the JAX package; the pruned weights go back to the
device the scope held them on."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .quantization import _host, _to_scope

__all__ = ["Pruner", "SensitivePruner", "apply_masks"]


class Pruner:
    """criterion='l1_norm': structured — zero whole output channels of conv
    filters / columns of fc weights with the smallest L1 norms.
    criterion='abs': unstructured — zero the smallest |w| entries."""

    def __init__(self, criterion: str = "l1_norm"):
        if criterion not in ("l1_norm", "abs"):
            raise ValueError(criterion)
        self.criterion = criterion

    def prune(self, program, scope, params: Sequence[str],
              ratios: Sequence[float]) -> Dict[str, np.ndarray]:
        """Zero pruned weights in the scope; returns {param: mask} so the
        train loop can re-apply after each update (apply_masks)."""
        masks: Dict[str, np.ndarray] = {}
        blk = program.global_block
        for name, ratio in zip(params, ratios):
            old = scope.find_var(name)
            w = _host(old)
            if self.criterion == "abs":
                k = int(w.size * ratio)
                mask = np.ones(w.size, bool)
                if k > 0:
                    idx = np.argsort(np.abs(w).ravel())[:k]
                    mask[idx] = False
                mask = mask.reshape(w.shape)
            else:
                # channel axis: 0 for conv [oc,...], last for fc [in,out]
                axis = 0 if w.ndim >= 3 else w.ndim - 1
                moved = np.moveaxis(w, axis, 0).reshape(w.shape[axis], -1)
                norms = np.abs(moved).sum(1)
                k = int(len(norms) * ratio)
                mask = np.ones_like(w, bool)
                if k > 0:
                    drop = np.argsort(norms)[:k]
                    sl = [slice(None)] * w.ndim
                    sl[axis] = drop
                    mask[tuple(sl)] = False
            masks[name] = mask
            scope.set_var(name, _to_scope(w * mask, old))
        return masks

    def sensitivity(self, program, scope, params: Sequence[str],
                    eval_fn, ratios=(0.1, 0.3, 0.5)) -> Dict[str, Dict]:
        """Per-param loss sensitivity curve (reference slim sensitivity
        analysis): prune each param alone at each ratio, record eval_fn()."""
        out: Dict[str, Dict] = {}
        for name in params:
            saved = scope.find_var(name)
            saved_host = _host(saved)
            curve = {}
            for r in ratios:
                self.prune(program, scope, [name], [r])
                curve[float(r)] = float(eval_fn())
                scope.set_var(name, _to_scope(saved_host, saved))
            out[name] = curve
        return out


def apply_masks(scope, masks: Dict[str, np.ndarray]) -> None:
    """Re-zero pruned weights (call after optimizer steps)."""
    for name, mask in masks.items():
        w = scope.find_var(name)
        scope.set_var(name, w * torch.as_tensor(mask, dtype=w.dtype,
                                                device=w.device))


class SensitivePruner:
    """Sensitivity-driven pruning schedule (reference: slim's sensitive
    pruning strategy): measure each param's loss-vs-ratio curve, then
    allocate per-param ratios so the network-wide sparsity target is met
    while equalizing the estimated loss increase across params — prune
    the insensitive layers harder."""

    def __init__(self, criterion: str = "l1_norm",
                 ratios=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7)):
        self.pruner = Pruner(criterion)
        self.ratios = tuple(float(r) for r in ratios)

    def _allocate(self, curves: Dict[str, Dict], sizes: Dict[str, int],
                  target_ratio: float) -> Dict[str, float]:
        """Pick a loss-increase budget by bisection so the weighted mean
        of the per-param max ratios within budget hits target_ratio."""
        bases = {n: min(c.values()) for n, c in curves.items()}

        def ratios_for(budget):
            out = {}
            for n, c in curves.items():
                ok = [r for r, l in sorted(c.items())
                      if l - bases[n] <= budget]
                out[n] = max(ok) if ok else 0.0
            return out

        total = sum(sizes.values())
        lo, hi = 0.0, max(max(c.values()) - bases[n]
                          for n, c in curves.items()) + 1e-9
        for _ in range(30):
            mid = (lo + hi) / 2
            got = sum(sizes[n] * r
                      for n, r in ratios_for(mid).items()) / total
            if got < target_ratio:
                lo = mid
            else:
                hi = mid
        return ratios_for(hi)

    def prune(self, program, scope, params: Sequence[str], eval_fn,
              target_ratio: float):
        """Returns (masks, per_param_ratios) — masks feed apply_masks();
        the ratio dict records what the sensitivity allocation chose."""
        curves = self.pruner.sensitivity(program, scope, params, eval_fn,
                                         self.ratios)
        sizes = {n: int(scope.find_var(n).numel())
                 for n in params}
        alloc = self._allocate(curves, sizes, target_ratio)
        masks = self.pruner.prune(program, scope, list(params),
                                  [alloc[n] for n in params])
        return masks, alloc
