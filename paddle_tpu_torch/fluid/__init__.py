"""paddle_tpu_torch.fluid — the static-graph front end of the port.

Parity surface: python/paddle/fluid/__init__.py in the reference, ported
from the JAX package's ``fluid``: the same Program / layers / Executor
API, executing op by op in torch on one device (the CUDA card unless the
Executor is given ``device="cpu"``), with ``append_backward``, the
optimizers and meta-optimizers, the in-graph learning-rate schedules
(exported into ``layers`` as the reference does), the static verifier
(``analysis``) and preemption-safe checkpoints (``CheckpointManager``).
Dygraph mode (only ``dygraph.save_dygraph`` / ``load_dygraph`` so far)
and the dataset / reader front ends wait for later slices (ROADMAP).
"""
from . import (  # noqa: F401
    backward,
    clip,
    dtypes,
    executor,
    framework,
    initializer,
    io,
    layers,
    learning_rate_scheduler,
    optimizer,
    param_attr,
    regularizer,
    unique_name,
)
from . import analysis, checkpoint, dygraph, monitor  # noqa: F401
from .checkpoint import CheckpointManager  # noqa: F401

for _n in ("noam_decay", "exponential_decay", "natural_exp_decay",
           "inverse_time_decay", "polynomial_decay", "piecewise_decay",
           "cosine_decay", "linear_lr_warmup"):
    setattr(layers, _n, getattr(learning_rate_scheduler, _n))
del _n
from .backward import append_backward, calc_gradient, gradients  # noqa: F401
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


def data(name, shape, dtype="float32", lod_level=0):
    """The data layer (fluid.data in 1.8+): ``layers.data`` with the
    shape as given, no batch dim prepended."""
    return layers.tensor.data(name, shape, dtype, lod_level,
                              append_batch_size=False)
