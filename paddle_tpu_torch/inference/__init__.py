"""Inference API: config + predictor.

Port of `paddle_tpu/inference/__init__.py` (Config, Predictor,
create_predictor :31-131). Reference: paddle/fluid/inference/api/ —
`AnalysisConfig` + `AnalysisPredictor` (analysis_predictor.cc): load a
saved inference model and run it.

Here the predictor loads a native model directory (`io.load_inference_model`)
and runs it with the port's eager Executor. The place is real:
`enable_use_gpu()` is the default and runs on `CUDAPlace(device_id)`;
`disable_gpu()` runs on the CPU. A GPU config on a machine without one
raises when the predictor is created. `create_engine` builds the
continuous-batching serving engine on the same place. Not ported yet:
`PredictorPool` and the `export_*` functions.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["Config", "AnalysisConfig", "Predictor", "create_predictor",
           "create_engine"]


class Config:
    """AnalysisConfig analog. The GPU toggles pick the predictor's place;
    MKLDNN/TensorRT/memory-optim toggles are accepted and ignored."""

    def __init__(self, model_dir: Optional[str] = None):
        self._model_dir = model_dir
        self._use_gpu = True
        self._device_id = 0
        self.switch_ir_optim_ = True

    def set_model(self, model_dir: str):
        self._model_dir = model_dir

    def model_dir(self) -> str:
        return self._model_dir

    def enable_use_gpu(self, memory_pool_init_size_mb: int = 0,
                       device_id: int = 0):
        self._use_gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self) -> bool:
        return self._use_gpu

    def place(self):
        from ..framework.executor import CPUPlace, CUDAPlace
        return CUDAPlace(self._device_id) if self._use_gpu else CPUPlace()

    _warned: set = set()

    @classmethod
    def _warn_ignored(cls, opt: str):
        if opt not in cls._warned:
            cls._warned.add(opt)
            import warnings
            warnings.warn(
                f"inference.Config.{opt} is ignored by paddle_tpu_torch; "
                "accepted for API compatibility only", stacklevel=3)

    def enable_mkldnn(self):
        self._warn_ignored("enable_mkldnn")

    def enable_tensorrt_engine(self, *a, **kw):
        self._warn_ignored("enable_tensorrt_engine")

    def switch_ir_optim(self, flag: bool = True):
        self.switch_ir_optim_ = flag

    def enable_memory_optim(self):
        self._warn_ignored("enable_memory_optim")


AnalysisConfig = Config


class Predictor:
    """AnalysisPredictor analog: the loaded inference program, its own
    Scope, and an Executor on the config's place."""

    def __init__(self, config: Config):
        from ..framework.executor import Executor, Scope, scope_guard
        from .. import io
        if not config.model_dir():
            raise ValueError("Config.set_model(model_dir) is required")
        self._exe = Executor(config.place())
        self._scope = Scope()
        with scope_guard(self._scope):
            self._program, self._feed_names, self._fetch_vars = \
                io.load_inference_model(config.model_dir(), self._exe)

    @property
    def device(self):
        return self._exe.device

    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return [v.name for v in self._fetch_vars]

    def run(self, inputs, return_numpy: bool = True) -> List[np.ndarray]:
        """inputs: dict name->array, or list of arrays in get_input_names
        order (ZeroCopy style). return_numpy=False keeps the outputs as
        tensors on the predictor's device."""
        from ..framework.executor import scope_guard
        from ..observability.tracer import trace_span
        if not isinstance(inputs, dict):
            inputs = dict(zip(self._feed_names, inputs))
        with trace_span("inference/predict", "inference"):
            with scope_guard(self._scope):
                return self._exe.run(self._program, feed=inputs,
                                     fetch_list=self._fetch_vars,
                                     return_numpy=return_numpy)

    # ZeroCopyTensor-flavored API
    def set_input(self, name: str, value):
        self._pending = getattr(self, "_pending", {})
        self._pending[name] = value

    def zero_copy_run(self) -> List[np.ndarray]:
        out = self.run(getattr(self, "_pending", {}))
        self._pending = {}
        return out


def create_predictor(config: Config) -> Predictor:
    """create_paddle_predictor analog."""
    return Predictor(config)


def create_engine(config, gpt_config, serving=None, dtype=None,
                  debug_port=None):
    """Build a continuous-batching `serving.ServingEngine` from a saved
    GPT model dir. Port of `paddle_tpu/inference/__init__.py:134`: the
    model loads through the Predictor, and the engine reads the decode
    weights out of the predictor's scope by the var names models/gpt.py's
    programs create, so it serves on the predictor's place — the card
    unless the Config says `disable_gpu()` (and a GPU config raises
    without one).

    config: inference.Config (or a model_dir string); gpt_config: the
    models.gpt.GPTConfig the saved model was built with; serving: a
    serving.ServingConfig (defaults apply when None). Not ported yet,
    each raising NotImplementedError: dtype (ROADMAP A.1.4) and
    debug_port (A.11)."""
    from ..models.gpt_decode import collect_gpt_params
    from ..serving import ServingConfig, ServingEngine

    if dtype is not None:
        raise NotImplementedError(
            "create_engine(dtype=...) is not ported to paddle_tpu_torch "
            "yet (ROADMAP A.1.4)")
    if debug_port is not None:
        raise NotImplementedError(
            "create_engine(debug_port=...) is not ported to "
            "paddle_tpu_torch yet (ROADMAP A.11)")
    if isinstance(config, str):
        config = Config(config)
    pred = Predictor(config)
    params = collect_gpt_params(pred._scope, gpt_config)
    return ServingEngine(params, gpt_config,
                         serving if serving is not None
                         else ServingConfig())
