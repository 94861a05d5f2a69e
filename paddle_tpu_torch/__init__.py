"""paddle_tpu_torch — the PyTorch + CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its layout so each module's counterpart is found under the same path.
It imports ``torch`` and ``numpy`` and never ``jax`` or ``paddle_tpu``.

Ported so far: the continuous-batching generation engine
(``inference.engine``) over the paged KV pool (``inference.kv_cache``)
and the decoder LM (``inference.decode_model``), whose decode step runs
the hand-written CUDA paged-attention kernel
(``ops.kernels.paged_attention``); and the frozen-Program ``infer`` path:
the Program IR, layers and Executor (``fluid``), the op emitters
(``ops``), ``inference.freeze`` / ``inference.predictor`` and BERT
(``models.bert``), whose attention and LayerNorm run the CUDA kernels
``ops.kernels.flash_attention`` and ``ops.kernels.add_ln``; and BERT
pretraining: ``fluid.backward`` (generic grad ops through
``torch.autograd``), the SGD / Momentum / Adam / AdamW optimizers
(``fluid.optimizer``, ``ops.optimizer_ops``), bf16 AMP
(``contrib.mixed_precision``) and the fused encoder stack
(``ops.encoder_stack``), with the backward kernels of flash attention and
LayerNorm and the forward's in-kernel Philox dropout; and ResNet
training (``models.resnet``): the conv / pool / batch-norm emitters, the
conv+BN fusion pass (``fluid.fusion_pass``) and the fused conv+BN
kernels (``ops.kernels.conv_bn``), with the fold of a frozen ResNet;
the hapi and Transformer NMTs, the RPC serving replica; and
preemption-safe training: the static verifier (``fluid.analysis``),
checkpoints (``fluid.checkpoint``) and ``hapi.Model.fit`` with
``checkpoint_dir``/``resume``; and the job control plane: the launcher
(``distributed.launch``), heartbeats, the lease coordinator and the
sharded checkpoint with its commit barrier, with ``Model.fit``'s
elastic ``reshard``; and the parameter server: host-memory embedding
tables (``distributed.ps``), the PS server with its sync barrier,
snapshots and replication (``distributed.ps_server``), the
``distributed_lookup_table`` op (``ops.ps_ops``), the
``DistributeTranspiler`` and the launcher's pserver mode.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; see :func:`resolve_device`.
"""
from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None):
    """The torch device an entry point runs on.

    ``None`` means the CUDA card.  When CUDA is absent that raises
    instead of falling back: a caller that wants the CPU says so with
    ``device="cpu"``."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default, and "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
