"""Program IR, op registry and executor of the PyTorch port."""

from .core import (Program, Block, Operator, Variable, Parameter,  # noqa: F401
                   program_guard, default_main_program,
                   default_startup_program, unique_name, unique_name_guard,
                   name_scope, grad_var_name, convert_np_dtype)
from .executor import (Executor, Scope, global_scope, scope_guard,  # noqa: F401
                       CPUPlace, CUDAPlace, as_torch_function)
from .backward import append_backward, gradients  # noqa: F401
from .layer_helper import (LayerHelper, ParamAttr,  # noqa: F401
                           WeightNormParamAttr)
from .passes import (Pass, PassRegistry, register_pass,  # noqa: F401
                     apply_pass, get_pass, Pattern, PatternPass, Match,
                     find_matches, replace_ops)
from . import builtin_passes  # noqa: F401  (registers the named passes)
