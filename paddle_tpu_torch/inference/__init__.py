"""Serving on the card: the continuous-batching generation engine over a
paged KV pool and the decoder LM whose decode step runs the CUDA
paged-attention kernel.

    from paddle_tpu_torch.inference import (DecoderConfig,
                                            GenerationEngine,
                                            TinyDecoderLM)
    eng = GenerationEngine(TinyDecoderLM(DecoderConfig(), device="cuda"),
                           max_slots=8, page_size=16, n_pages=513)
    out = eng.result(eng.submit([1, 2, 3], max_new_tokens=16))

The frozen-Program ``infer`` path (BERT-base with the flash-attention
and LayerNorm kernels on the card):

    from paddle_tpu_torch.inference import freeze_program, ServingPredictor
    frozen = freeze_program(main, scope=scope, fetch_list=[seq_out, pooled])
    seq, pooled = ServingPredictor(frozen).run(feed)

The file-based ``Config``/``Predictor`` (``io.load_inference_model``)
and the RPC server are not ported yet.
"""
from __future__ import annotations

from .decode_model import DecoderConfig, TinyDecoderLM  # noqa: F401
from .engine import (GenerationEngine, GenRequest,  # noqa: F401
                     kv_cache_enabled)
from .freeze import FrozenModel, freeze_program  # noqa: F401
from .kv_cache import PagedKVPool  # noqa: F401
from .server import (DeadlineExceeded, Overloaded,  # noqa: F401
                     ResumedOnNewWeights)
from .predictor import Predictor as ServingPredictor  # noqa: F401
from .predictor import shared_executor  # noqa: F401
