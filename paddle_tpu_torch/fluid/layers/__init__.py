"""fluid.layers namespace (the layers BERT, ResNet and the hapi
Transformer NMT build with).
Parity: python/paddle/fluid/layers/__init__.py; ported from the JAX
package's ``fluid/layers``."""
from . import misc, nn, ops, sequence, tensor  # noqa: F401
from .misc import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
