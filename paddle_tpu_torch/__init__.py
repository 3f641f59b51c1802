"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The same Program IR, layers DSL and on-disk model format as the JAX
package, executed eagerly op by op on torch tensors; attention runs on
hand-written Hopper (sm_90a) CUDA kernels. It imports torch and never jax
nor paddle_tpu. It covers GPT-2 inference (Program -> Executor ->
fused_attention, the native io format and the inference Predictor), the
GPT-2 training step (append_backward, SGD/Adam, the attention backward on
three Hopper kernels), the BERT MLM pretrain step with the bf16 AMP
rewrite (`contrib.mixed_precision`) and ResNet training (Momentum, fp32 or
AMP) and serving (`models.resnet`; convolutions through cuDNN).

Places are real: `Executor()` runs on `CUDAPlace(0)` and raises when no GPU
is present; `Executor(CPUPlace())` runs on the CPU.
"""

from . import ops  # registers the op rules
from .framework import (Program, Block, Operator, Variable, Parameter,
                        program_guard, default_main_program,
                        default_startup_program, unique_name,
                        unique_name_guard, name_scope,
                        Executor, Scope, global_scope, scope_guard,
                        CPUPlace, CUDAPlace, append_backward, gradients,
                        LayerHelper, ParamAttr)
from . import layers
from . import optimizer
from . import initializer
from . import io
from . import observability
from . import inference
from . import contrib

__version__ = "0.1.0"

__all__ = ["Program", "Block", "Operator", "Variable", "Parameter",
           "program_guard", "default_main_program",
           "default_startup_program", "unique_name", "unique_name_guard",
           "name_scope", "Executor", "Scope", "global_scope", "scope_guard",
           "CPUPlace", "CUDAPlace", "append_backward", "gradients",
           "LayerHelper", "ParamAttr", "layers", "optimizer", "initializer",
           "io", "observability", "inference", "contrib"]
