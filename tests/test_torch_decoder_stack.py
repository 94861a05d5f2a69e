"""The port's ``fused_decoder_stack`` emitter against the JAX package's:
the forward and the gradients of all 22 stacked parameters, Hidden,
EncOut and SrcBias, on the same numpy inputs with dropout 0, in f32.

Configurations: hidden 128 as 2 heads of 64, St = 128 target positions
over Ss = 256 source positions, 2 layers, where both attentions take the
BSH flash branch in both packages (causal self-attention with no bias;
the rectangular cross-attention with the per-key [B, 1, 1, Ss] source
bias: the JAX package's Pallas kernels in interpret mode under
``FORCE_PALLAS``, the port's kernels' plain versions); the same with a
full [B, nh, St, Ss] cross bias, which the cross-attention takes through
the composition in both (the JAX decoder stack has no BHSD branch); and
hidden 32 as 4 heads of 8 (the composition for both attentions).  Each
with and without ``remat_ffn``.

Tolerances: Out 5e-5 and every gradient 5e-5 + 5e-5 * |grad| (the same
f32 math; the kernels' online softmax and the two frameworks' matmuls sum
in other orders, over up to 256 terms, and each of the six LayerNorms
rescales what came before; measured up to 3.4e-5 on Out).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jax_attention
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import encoder_stack as tstack
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.kernels import flash_attention as fa

ATOL = RTOL = 5e-5
# b, St, Ss, h, nh, f, L, cross bias
CONFIGS = {"bsh_key_bias": (2, 128, 256, 128, 2, 256, 2, "key"),
           "bsh_full_cross_bias": (2, 128, 256, 128, 2, 256, 2, "full"),
           "composition_h32": (2, 16, 24, 32, 4, 64, 2, "key")}


def _inputs(config, seed=0):
    b, st, ss, h, nh, f, L, cross = CONFIGS[config]
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.08):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    lens = np.array([ss, ss // 2 + 3])[:b]
    live = np.arange(ss)[None, :] < lens[:, None]
    bias = np.where(live, 0.0, -1e4).astype(np.float32)[:, None, None, :]
    if cross == "full":
        bias = (bias + w(b, nh, st, ss, scale=1.0)).astype(np.float32)
    shapes = {"SelfQKVW": (h, 3 * h), "SelfQKVB": (3 * h,),
              "SelfOutW": (h, h), "SelfOutB": (h,),
              "CrossQW": (h, h), "CrossQB": (h,), "CrossKW": (h, h),
              "CrossKB": (h,), "CrossVW": (h, h), "CrossVB": (h,),
              "CrossOutW": (h, h), "CrossOutB": (h,),
              "FfnW1": (h, f), "FfnB1": (f,), "FfnW2": (f, h),
              "FfnB2": (h,)}
    ins = {"Hidden": w(b, st, h, scale=1.0), "EncOut": w(b, ss, h, scale=1.0),
           "SrcBias": bias}
    for k in tstack._DEC_PARAM_KEYS:
        if k in shapes:
            ins[k] = w(L, *shapes[k])
        else:  # Ln{1,2,3}{S,B}
            ins[k] = (1 + w(L, h)) if k.endswith("S") else w(L, h)
    cot = w(b, st, h, scale=1.0)
    attrs = {"num_heads": nh, "act": "relu", "dropout_prob": 0.0,
             "attn_dropout_prob": 0.0, "is_test": False,
             "use_flash_attention": True, "rng_salt": 1}
    return ins, cot, attrs


def _jax(ins, cot, attrs):
    spec = jreg.get("fused_decoder_stack")

    def fn(p):
        return spec.emit(jreg.EmitContext(rng_key=jax.random.PRNGKey(0)),
                         {k: [v] for k, v in p.items()}, dict(attrs))["Out"][0]

    out, vjp = jax.vjp(fn, {k: jnp.asarray(v) for k, v in ins.items()})
    (grads,) = vjp(jnp.asarray(cot))
    return np.asarray(out), {k: np.asarray(g) for k, g in grads.items()}


def _torch(ins, cot, attrs, seed=0):
    leaves = {k: torch.as_tensor(v).requires_grad_() for k, v in ins.items()}
    out = treg.get("fused_decoder_stack").emit(
        treg.EmitContext(seed=seed), {k: [v] for k, v in leaves.items()},
        dict(attrs))["Out"][0]
    grads = torch.autograd.grad(out, list(leaves.values()),
                                torch.as_tensor(cot), allow_unused=True)
    return out.detach().numpy(), {
        k: np.zeros_like(ins[k]) if g is None else g.numpy()
        for k, g in zip(leaves, grads)}


@pytest.mark.parametrize("remat", [False, True], ids=["none", "remat_ffn"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_decoder_stack_forward_and_grads_match_jax(config, remat,
                                                   monkeypatch):
    ins, cot, attrs = _inputs(config)
    attrs["remat_ffn"] = remat
    jax_attention.FORCE_PALLAS = config.startswith("bsh")
    try:
        out_j, g_j = _jax(ins, cot, attrs)
    finally:
        jax_attention.FORCE_PALLAS = False
    calls = []
    real = fa._FlashBSH.apply
    monkeypatch.setattr(fa._FlashBSH, "apply",
                        lambda *a: calls.append(tuple(a[0].shape)) or real(*a))
    monkeypatch.setattr(fa._FlashBHSD, "apply",
                        lambda *a: pytest.fail("the decoder has no BHSD "
                                               "branch"))
    out_t, g_t = _torch(ins, cot, attrs)
    b, st, ss, h, _, _, layers, cross = CONFIGS[config]
    if config.startswith("bsh"):
        # self-attention in every layer; cross-attention only with the
        # per-key source bias
        per_layer = [(b, st, h)] + ([(b, st, h)] if cross == "key" else [])
        assert calls == per_layer * layers
    else:
        assert calls == []
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=0)
    assert sorted(g_t) == sorted(ins)
    for k, g in g_t.items():
        assert g.shape == ins[k].shape, k
        np.testing.assert_allclose(g, g_j[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_decoder_dropout_is_seeded_per_step_and_remat_safe():
    """With dropout on, ``remat_ffn``'s recompute draws the same bits,
    and the step seed reaches every draw."""
    ins, cot, attrs = _inputs("composition_h32", seed=1)
    attrs.update(dropout_prob=0.2, attn_dropout_prob=0.2)
    out0, g0 = _torch(ins, cot, attrs, seed=7)
    out1, g1 = _torch(ins, cot, dict(attrs, remat_ffn=True), seed=7)
    out2, _ = _torch(ins, cot, attrs, seed=8)
    np.testing.assert_array_equal(out0, out1)
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)
    assert not np.array_equal(out0, out2)
    test_mode, _ = _torch(ins, cot, dict(attrs, is_test=True), seed=7)
    no_drop, _ = _torch(ins, cot, dict(attrs, dropout_prob=0.0,
                                       attn_dropout_prob=0.0), seed=7)
    np.testing.assert_array_equal(test_mode, no_drop)


def test_decoder_sequence_parallel_raises():
    """The decoder's ring splits the trg tokens over the sp ranks: a
    length the sp size does not divide raises before any collective (the
    ring itself is held against JAX in test_torch_fleet.py)."""
    from paddle_tpu_torch.parallel import Mesh

    ins, cot, attrs = _inputs("composition_h32")
    ctx = treg.EmitContext(mesh=Mesh({"sp": 3}))
    with pytest.raises(ValueError, match="ring"):
        treg.get("fused_decoder_stack").emit(
            ctx, {k: [torch.as_tensor(v)] for k, v in ins.items()},
            dict(attrs, sequence_parallel=True))
