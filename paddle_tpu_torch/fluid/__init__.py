"""paddle_tpu_torch.fluid — the static-graph front end of the port.

Parity surface: python/paddle/fluid/__init__.py in the reference, ported
from the JAX package's ``fluid``: the same Program / layers / Executor
API, executing op by op in torch on one device (the CUDA card unless the
Executor is given ``device="cpu"``).  Optimizers, backward, dygraph and
the dataset / reader front ends wait for later slices (ROADMAP).
"""
from . import (  # noqa: F401
    dtypes,
    executor,
    framework,
    initializer,
    io,
    layers,
    param_attr,
    unique_name,
)
from .executor import Executor, Scope, global_scope, scope_guard  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401
from .framework import (  # noqa: F401
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
