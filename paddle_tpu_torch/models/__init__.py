"""Models built on the port's static-graph API (ported from the JAX
package's ``models``): BERT, ResNet and the Transformer-base NMT."""
from . import bert, resnet, transformer  # noqa: F401
from .bert import BertConfig, build_bert_pretrain_program  # noqa: F401
from .resnet import ResNetConfig, build_resnet_train_program  # noqa: F401
from .transformer import (TransformerConfig,  # noqa: F401
                          build_transformer_nmt_program)
