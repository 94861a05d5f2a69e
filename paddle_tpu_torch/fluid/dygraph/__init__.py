"""fluid.dygraph: only the state-dict files so far.

``save_dygraph`` / ``load_dygraph`` (``checkpoint.py``, the JAX
package's file as it is: a pickle of numpy arrays, the ``.pdparams`` /
``.pdopt`` convention, written through ``fluid/io.py``'s atomic write).
Dygraph mode itself (``Layer``, ``guard``, ``to_static``) waits for its
slice (ROADMAP A9).
"""
from .checkpoint import load_dygraph, save_dygraph  # noqa: F401
