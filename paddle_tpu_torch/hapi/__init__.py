"""hapi: the high-level API's NLP building blocks.

Parity surface: the reference's python/paddle/incubate/hapi; ported from
the JAX package's ``hapi``.  Ported so far: the transformer blocks of
``hapi.text`` (``MultiHeadAttention``, ``FFN``, ``PrePostProcessLayer``,
``TransformerEncoder``, ``TransformerDecoder``), static-graph builders
that emit ops into the current Program.  ``Model`` (fit / evaluate /
predict), the RNN cells, ``TransformerCell``, beam search and the CRF
wait for a later slice (ROADMAP A11).
"""
from . import text  # noqa: F401
