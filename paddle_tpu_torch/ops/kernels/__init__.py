"""Hand-written CUDA kernels (sources in ``csrc/``, one library each,
built by ``_build``), each in a module beside its plain PyTorch version.

| module            | replaces (TPU)                                          |
| ----------------- | ------------------------------------------------------- |
| paged_attention   | paddle_tpu/ops/pallas/paged_attention.py (_paged_kernel) |
| flash_attention   | paddle_tpu/ops/pallas/flash_attention.py (BSH forward)  |
| add_ln            | paddle_tpu/ops/pallas/add_ln.py (forward)               |
"""
