"""Models built on the port's static-graph API (ported from the JAX
package's ``models``): BERT so far."""
from . import bert  # noqa: F401
from .bert import BertConfig, build_bert_pretrain_program  # noqa: F401
