"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The same Program IR, layers DSL and on-disk model format as the JAX
package, executed eagerly op by op on torch tensors; attention runs on
hand-written Hopper (sm_90a) CUDA kernels. It imports torch and never jax
nor paddle_tpu. It covers GPT-2 inference (Program -> Executor ->
fused_attention, the native io format and the inference Predictor), the
GPT-2 training step (append_backward, SGD/Adam, the attention backward on
three Hopper kernels), the BERT MLM pretrain step with the bf16 AMP
rewrite (`contrib.mixed_precision`), ResNet training (Momentum, fp32 or
AMP) and serving (`models.resnet`; convolutions through cuDNN), and the
continuous-batching GPT serving engine (`serving`,
`inference.create_engine`) over the paged KV decode path of
`models.gpt_decode`, with host-swap preemption and live migration, and
the HTTP server tier over it (`server.serve`: router, replicas, the
debug and alert planes of `observability`), the NMT Transformer's train
step and its greedy and beam-search decoders (`models.transformer`,
`layers.decode`, `as_torch_function`), LeNet, VGG-16 and the book
models (`models.{lenet,vgg,book}`, `nets`), the Switch MoE FFN
(`nets.switch_moe_ffn`), every optimizer of the JAX package with LR
schedules, regularizers and SelectedRows sparse embedding gradients
(`optimizer`, `layers.learning_rate_scheduler`, `regularizer`,
`framework.selected_rows`), and control flow, LoD and the recurrences
(`layers.control_flow`, `layers.rnn`, `layers.sequence`, `lod_tensor`,
`reader.bucketing`) with the recurrent book models, and the host-boundary
ops and IO: save/load ops, both checkpoint formats (`io`,
`framework.fluid_interop`), async saves, the readers (`reader`,
`PyReader`, `DataFeeder`, the reader ops), the loss ops (CTC, CRF, NCE,
hierarchical sigmoid) and the metric ops, `metrics` and `average`, and
the parameter server: the pskv service (`distributed.pskv`, a C++ server
built with g++ at first use), `transpiler.DistributeTranspiler` and its
trainer runtime, the RPC and PS ops, the async `distributed.Communicator`,
elastic membership, `distributed.launch`, the PS fleet (`incubate`) and
DeepFM (`models.deepfm`), and the pass framework
(`framework.apply_pass`, the builtin fuse, AMP and quantization passes)
with model compression (`contrib.slim`: quantization-aware training,
freezing, post-training quantization, pruning, distillation, light-NAS).

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
                        LayerHelper, ParamAttr, WeightNormParamAttr,
                        as_torch_function)
from . import layers
from . import nets
from . import optimizer
from . import regularizer
from . import initializer
from . import io
from . import observability
from . import inference
from . import contrib
from . import profiler
from . import serving
from . import server
from . import analysis
from . import clip
from . import compiler
from . import lod_tensor
from .lod_tensor import create_lod_tensor, create_random_int_lodtensor
from . import reader
from . import metrics
from . import average
from . import transpiler
from . import distributed
from . import incubate
from .data_feeder import DataFeeder
from .reader.py_reader import PyReader
from .compiler import CompiledProgram, BuildStrategy, ExecutionStrategy

__version__ = "0.1.0"

__all__ = ["Program", "Block", "Operator", "Variable", "Parameter",
           "program_guard", "default_main_program",
           "default_startup_program", "unique_name", "unique_name_guard",
           "name_scope", "Executor", "Scope", "global_scope", "scope_guard",
           "CPUPlace", "CUDAPlace", "append_backward", "gradients",
           "as_torch_function", "LayerHelper", "ParamAttr",
           "WeightNormParamAttr", "layers",
           "nets", "optimizer", "regularizer", "initializer", "io",
           "observability", "inference", "contrib", "profiler",
           "serving", "server", "analysis", "clip", "compiler",
           "CompiledProgram", "BuildStrategy", "ExecutionStrategy",
           "lod_tensor", "create_lod_tensor", "create_random_int_lodtensor",
           "reader", "metrics", "average", "transpiler", "distributed",
           "incubate", "DataFeeder", "PyReader"]
