"""fluid.layers namespace (the layers ``models/bert.py`` builds with).
Parity: python/paddle/fluid/layers/__init__.py; ported from the JAX
package's ``fluid/layers``."""
from . import nn, ops, tensor  # noqa: F401
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
