"""Hand-written CUDA kernels (sources in ``csrc/``, built by ``_build``),
each in a module beside its plain PyTorch version.

| module            | replaces (TPU)                                  |
| ----------------- | ----------------------------------------------- |
| paged_attention   | paddle_tpu/ops/pallas/paged_attention.py        |
"""
