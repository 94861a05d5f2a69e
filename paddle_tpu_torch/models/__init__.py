"""Models built on the port's static-graph API (ported from the JAX
package's ``models``): BERT and ResNet."""
from . import bert, resnet  # noqa: F401
from .bert import BertConfig, build_bert_pretrain_program  # noqa: F401
from .resnet import ResNetConfig, build_resnet_train_program  # noqa: F401
