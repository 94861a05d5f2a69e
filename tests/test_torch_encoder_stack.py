"""The port's ``fused_encoder_stack`` emitter against the JAX package's:
the forward and the gradients of all 12 stacked parameters and Hidden,
on the same numpy inputs with dropout 0, in f32.

Two configurations: hidden 128 as 2 heads of 64 at S = 128 over 2 layers,
where both packages take the BSH flash branch (the JAX package's Pallas
kernels in interpret mode under ``FORCE_PALLAS``, the port's flash and
LayerNorm kernels' plain versions through their autograd Functions); and
hidden 32 as 4 heads of 8 (the composition branch in both).  Each runs
without remat, with ``remat_ffn``, ``remat_qkv`` and ``remat_layer``, and
with ``remat_policy`` "flash" and "flash,ln1_out,attn_out" (the JAX
package's checkpoint-name policy, the same attrs on both sides), whose
recompute must not change a number; under a policy that keeps o and lse
the flash forward runs once a layer.  The gradients are pulled back
from one random cotangent of Out (JAX: ``jax.vjp`` of the emitter; the
port: ``torch.autograd``).

Tolerances: Out 2e-5 and every gradient 2e-5 + 2e-5 * |grad| (the same
f32 math; the kernels' online softmax and the two frameworks' matmuls sum
in other orders, over up to 256 terms).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jax_attention
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.kernels import flash_attention as fa

KEYS = ("QKVW", "QKVB", "OutW", "OutB", "Ln1S", "Ln1B", "FfnW1", "FfnB1",
        "FfnW2", "FfnB2", "Ln2S", "Ln2B")
ATOL = RTOL = 2e-5

CONFIGS = {"bsh_h128_s128": (2, 128, 128, 2, 256, 2),
           "composition_h32": (2, 16, 32, 4, 64, 2)}
REMAT = {"none": {}, "remat_ffn": {"remat_ffn": True},
         "remat_qkv": {"remat_qkv": True},
         "remat_layer": {"remat_layer": True},
         # a policy switches the blanket flags off: the layer keeps the
         # flash forward's o and lse and recomputes the rest
         "policy_flash": {"remat_policy": "flash", "remat_layer": True},
         "policy_flash_ln1_attn": {"remat_policy": "flash,ln1_out,attn_out"}}


def _inputs(config, seed=0):
    b, s, h, nh, f, L = CONFIGS[config]
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.08):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    lens = np.array([s, s // 2 + 3])[:b]
    live = np.arange(s)[None, :] < lens[:, None]
    ins = {"Hidden": w(b, s, h, scale=1.0),
           "AttnBias": np.where(live, 0.0, -1e4).astype(np.float32)[
               :, None, None, :],
           "QKVW": w(L, h, 3 * h), "QKVB": w(L, 3 * h),
           "OutW": w(L, h, h), "OutB": w(L, h),
           "Ln1S": 1 + w(L, h), "Ln1B": w(L, h),
           "FfnW1": w(L, h, f), "FfnB1": w(L, f),
           "FfnW2": w(L, f, h), "FfnB2": w(L, h),
           "Ln2S": 1 + w(L, h), "Ln2B": w(L, h)}
    cot = w(b, s, h, scale=1.0)
    attrs = {"num_heads": nh, "act": "gelu", "dropout_prob": 0.0,
             "attn_dropout_prob": 0.0, "is_test": False,
             "use_flash_attention": True, "rng_salt": 1}
    return ins, cot, attrs


def _jax(ins, cot, attrs):
    spec = jreg.get("fused_encoder_stack")

    def fn(p):
        return spec.emit(jreg.EmitContext(rng_key=jax.random.PRNGKey(0)),
                         {k: [v] for k, v in p.items()}, dict(attrs))["Out"][0]

    out, vjp = jax.vjp(fn, {k: jnp.asarray(v) for k, v in ins.items()})
    (grads,) = vjp(jnp.asarray(cot))
    return np.asarray(out), {k: np.asarray(g) for k, g in grads.items()}


def _torch(ins, cot, attrs, seed=0):
    leaves = {k: torch.as_tensor(v).requires_grad_(k != "AttnBias")
              for k, v in ins.items()}
    out = treg.get("fused_encoder_stack").emit(
        treg.EmitContext(seed=seed), {k: [v] for k, v in leaves.items()},
        dict(attrs))["Out"][0]
    keys = [k for k in leaves if k != "AttnBias"]
    grads = torch.autograd.grad(out, [leaves[k] for k in keys],
                                torch.as_tensor(cot))
    return out.detach().numpy(), dict(zip(keys, (g.numpy() for g in grads)))


@pytest.mark.parametrize("remat", sorted(REMAT))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_stack_forward_and_grads_match_jax(config, remat, monkeypatch):
    ins, cot, attrs = _inputs(config)
    attrs.update(REMAT[remat])
    jax_attention.FORCE_PALLAS = config.startswith("bsh")
    try:
        out_j, g_j = _jax(ins, cot, attrs)
    finally:
        jax_attention.FORCE_PALLAS = False
    calls = []
    real = fa._FlashBSH.apply
    monkeypatch.setattr(fa._FlashBSH, "apply",
                        lambda *a: calls.append(1) or real(*a))
    saved = []
    real_saved = fa._FlashBSHSaved.apply
    monkeypatch.setattr(fa._FlashBSHSaved, "apply",
                        lambda *a: saved.append(1) or real_saved(*a))
    out_t, g_t = _torch(ins, cot, attrs)
    layers = CONFIGS[config][-1]
    want_calls = layers if config.startswith("bsh") else 0
    if remat == "remat_layer" and want_calls:
        want_calls *= 2  # the recompute runs the forward again
    assert len(calls) == want_calls
    # the policy's recompute reads the stashed o and lse instead
    assert len(saved) == (want_calls if remat.startswith("policy") else 0)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=0)
    assert sorted(g_t) == sorted(KEYS + ("Hidden",))
    for k, g in g_t.items():
        assert g.shape == ins[k].shape, k
        np.testing.assert_allclose(g, g_j[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def _same_dropout(config, remat):
    ins, cot, attrs = _inputs(config, seed=1)
    attrs.update(dropout_prob=0.2, attn_dropout_prob=0.2)
    out0, g0 = _torch(ins, cot, attrs, seed=7)
    out1, g1 = _torch(ins, cot, dict(attrs, **REMAT[remat]), seed=7)
    out2, _ = _torch(ins, cot, attrs, seed=8)
    np.testing.assert_array_equal(out0, out1)
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)
    assert not np.array_equal(out0, out2)  # the step seed reaches the draw
    no_drop, _ = _torch(ins, cot, dict(attrs, dropout_prob=0.0,
                                       attn_dropout_prob=0.0))
    assert not np.allclose(out0, no_drop)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_remat_recompute_draws_the_same_dropout(config):
    """With dropout on, a checkpointed layer's recompute draws the same
    bits: the layer's generators are made inside it from (salted seed,
    layer index)."""
    _same_dropout(config, "remat_layer")


@pytest.mark.parametrize("remat", ["policy_flash", "policy_flash_ln1_attn"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_remat_policy_draws_the_same_dropout(config, remat):
    """The same under a ``remat_policy``: out and every gradient equal
    the no-remat run's bit for bit, the stashed o and lse included."""
    _same_dropout(config, remat)


def test_cheap_dropout_rescales_by_the_quantized_keep():
    from paddle_tpu_torch.ops.encoder_stack import _cheap_dropout

    x = torch.ones(256, 256)
    y = _cheap_dropout(x, 0.1, seed=3)
    kept = y != 0
    thresh = round(0.9 * 256)
    assert torch.all(y[kept] == 256 / thresh)
    assert abs(kept.float().mean().item() - thresh / 256) < 0.01
    assert torch.equal(y, _cheap_dropout(x, 0.1, seed=3))


@pytest.mark.parametrize("attrs", [{"pipeline": True},
                                   {"pipeline": True,
                                    "sequence_parallel": True}],
                         ids=["pipeline", "ring"])
def test_unported_branches_raise(attrs):
    """GPipe, alone or with the ring inside its stages (pp x sp), runs
    since the pipeline slice (test_torch_pipeline.py); what it refuses is
    the reference's: a batch of 2 that 3 microbatches do not divide
    raises ValueError, before any collective (a Mesh without a process
    group stands for the ranks)."""
    from paddle_tpu_torch.parallel import Mesh

    ins, cot, base = _inputs("composition_h32")
    mesh = Mesh({"pp": 2, "sp": 2})
    leaves = {k: torch.as_tensor(v if k in ("Hidden", "AttnBias")
                                 else v[:1]) for k, v in ins.items()}
    with pytest.raises(ValueError, match="num_microbatches=3"):
        treg.get("fused_encoder_stack").emit(
            treg.EmitContext(device="cpu", mesh=mesh),
            {k: [v] for k, v in leaves.items()},
            dict(base, num_microbatches=3, **attrs))


BHSD_BIASES = {"full": (2, 2, 128, 128), "full_b1": (2, 1, 128, 128),
               "key_shared": (1, 1, 1, 128)}


@pytest.mark.parametrize("force_pallas", [False, True],
                         ids=["jax_composition", "jax_pallas"])
@pytest.mark.parametrize("bias", sorted(BHSD_BIASES))
def test_stack_bhsd_branch_matches_jax(bias, force_pallas, monkeypatch):
    """A bias the BSH kernel cannot hold (the reference Transformer's full
    [B, nh, S, S] self-attention bias, a head-shared full one, a per-key
    one shared over the batch): the port's layers take the BHSD branch
    (its autograd Function once a layer), the JAX package's its BHSD
    Pallas kernel (FORCE_PALLAS) or its composition; Out and every
    gradient agree within the tolerances above."""
    ins, cot, attrs = _inputs("bsh_h128_s128")
    rng = np.random.default_rng(5)
    ins["AttnBias"] = np.where(rng.random(BHSD_BIASES[bias]) > 0.2, 0.0,
                               -1e4).astype(np.float32)
    jax_attention.FORCE_PALLAS = force_pallas
    try:
        out_j, g_j = _jax(ins, cot, attrs)
    finally:
        jax_attention.FORCE_PALLAS = False
    calls = []
    real = fa._FlashBHSD.apply
    monkeypatch.setattr(fa._FlashBHSD, "apply",
                        lambda *a: calls.append(1) or real(*a))
    out_t, g_t = _torch(ins, cot, attrs)
    assert len(calls) == CONFIGS["bsh_h128_s128"][-1]
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=0)
    for k, g in g_t.items():
        np.testing.assert_allclose(g, g_j[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)
