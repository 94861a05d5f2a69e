"""Automatic mixed precision: the bf16 cast rewrite and the optimizer
decorator.  Ported from the JAX package's ``contrib/mixed_precision``."""
from .decorator import OptimizerWithMixedPrecision, decorate  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
