"""Hand-written CUDA kernels (sources in ``csrc/``, one library each,
built by ``_build``), each in a module beside its plain PyTorch version.

| module            | replaces (TPU)                                          |
| ----------------- | ------------------------------------------------------- |
| paged_attention   | paddle_tpu/ops/pallas/paged_attention.py (_paged_kernel) |
| flash_attention   | paddle_tpu/ops/pallas/flash_attention.py (BSH fwd, bwd) |
| add_ln            | paddle_tpu/ops/pallas/add_ln.py (forward, backward)     |
| conv_bn           | paddle_tpu/ops/pallas/conv_bn.py (all five kernels)     |
"""


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process, by the
    wrapper's name; ``<name>_tc`` counts the launches of its tensor-core
    kernel apart.  A serving replica reports it in its ``stats``."""
    from . import add_ln, conv_bn, flash_attention as fa, paged_attention

    wrappers = {
        "paged_attention": paged_attention.paged_attention,
        "flash_attention_bsh": fa.flash_attention_bsh,
        "flash_attention_bsh_bwd": fa.flash_attention_bsh_bwd,
        "add_ln": add_ln.fused_add_ln,
        "add_ln_bwd": add_ln.fused_add_ln_bwd,
        "flash_attention": fa.flash_attention,
        "flash_attention_bwd_fused": fa.flash_attention_bwd_fused,
        "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
        "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
        "conv_stats": conv_bn.conv_stats, "mm_stats": conv_bn.mm_stats,
        "bn_apply": conv_bn.bn_apply, "bn_bwd_reduce": conv_bn.bn_bwd_reduce,
        "bn_bwd_dz": conv_bn.bn_bwd_dz}
    out = {}
    for name, fn in wrappers.items():
        out[name] = int(fn.launches)
        if hasattr(fn, "launches_tc"):
            out[f"{name}_tc"] = int(fn.launches_tc)
    return out
