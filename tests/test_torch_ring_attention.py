"""The port's ``ring_attention`` (``parallel/ring_attention.py``)
against the JAX package's ``ring_attention_global`` on a JAX sp mesh of
the same size, on the CPU: the output and the gradients of q, k, v and
the key bias, f32, within 2e-5.

The port's ranks are 2 or 4 gloo processes (``torch_dist_ranks.py``)
running ``ring_attention_global`` on the same numpy inputs; every rank's
gathered result must equal rank 0's bit for bit.  Both sides of
``flash_block_ok`` are covered, each as the JAX package routes it:

* S_local 16, D 8: the online-softmax ring in both packages;
* S_local 128, D 64: the flash-block ring, merged by log-sum-exp — the
  JAX package's Pallas ``flash_block_with_lse`` in interpret mode
  (``FORCE_PALLAS``), the port's ``flash_block_with_lse`` (its plain
  version on the CPU; the test counts its blocks: sp of them a case).

Each with causal off and on, with and without a per-key [B, S] padding
bias (masked keys -1e4, the rest random).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.ops import attention as jax_attention
from paddle_tpu.parallel import create_mesh
from paddle_tpu.parallel.ring_attention import ring_attention_global

import torch_dist_ranks

TOL = 2e-5
# name -> (B, nh, S_local, D)
SHAPES = {"online_softmax": (2, 2, 16, 8), "flash_block": (1, 2, 128, 64)}


def _cases(world):
    rng = np.random.default_rng(world)
    cases = []
    for shape in ("online_softmax", "flash_block"):
        b, nh, s_loc, d = SHAPES[shape]
        s = s_loc * world
        for causal in (False, True):
            for with_bias in (False, True):
                def f(*sh):
                    return rng.standard_normal(sh).astype(np.float32)

                bias = None
                if with_bias:
                    live = np.arange(s)[None, :] < np.array(
                        [s, s - s_loc // 2 - 3])[:b, None]
                    bias = np.where(live, 0.1 * f(b, s), -1e4).astype(
                        np.float32)
                cases.append({"shape": shape, "causal": causal,
                              "q": f(b, nh, s, d), "k": f(b, nh, s, d),
                              "v": f(b, nh, s, d), "bias": bias,
                              "ct": f(b, nh, s, d)})
    return cases


def _jax(world, case):
    mesh = create_mesh({"sp": world})
    args = [jnp.asarray(case[k]) for k in ("q", "k", "v")]
    with_bias = case["bias"] is not None
    if with_bias:
        args.append(jnp.asarray(case["bias"]))

    def fn(q, k, v, bias=None):
        return ring_attention_global(q, k, v, mesh, axis="sp", bias=bias,
                                     causal=case["causal"], batch_axis=None)

    def fwd_bwd(ct, *a):
        o, vjp = jax.vjp(fn, *a)
        return o, vjp(ct)

    jax_attention.FORCE_PALLAS = case["shape"] == "flash_block"
    try:
        o, grads = jax.jit(fwd_bwd)(jnp.asarray(case["ct"]), *args)
    finally:
        jax_attention.FORCE_PALLAS = False
    out = {"o": o, "dq": grads[0], "dk": grads[1], "dv": grads[2]}
    if with_bias:
        out["dbias"] = grads[3]
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_matches_jax(world, tmp_path):
    cases = _cases(world)
    started = torch_dist_ranks.Ranks("ring", world, tmp_path,
                                     {"cases": cases}, timeout=60.0)
    wants = [_jax(world, case) for case in cases]
    ranks = started.join()
    for i, (case, want) in enumerate(zip(cases, wants)):
        got = ranks[0][i]
        flash = case["shape"] == "flash_block"
        assert got.pop("flash_blocks") == (world if flash else 0)
        assert sorted(got) == sorted(want)
        what = f"{case['shape']} causal={case['causal']} " \
               f"bias={case['bias'] is not None}"
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0,
                                       err_msg=f"{what}: {k}")
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[i][k], got[k],
                                              err_msg=f"{what}: {k}")
        assert np.isfinite(got["o"]).all()


def test_key_bias_and_use_ring():
    """The key-bias reshape, its refusal of a full bias, and the gate:
    the attr alone, without an sp mesh of more than one rank, keeps the
    op off the ring."""
    import torch

    from paddle_tpu_torch.ops import registry as treg
    from paddle_tpu_torch.parallel import Mesh
    from paddle_tpu_torch.parallel.ring_attention import (
        key_bias_from_attn_bias, use_ring)

    b = torch.arange(8.0).reshape(2, 1, 1, 4)
    assert torch.equal(key_bias_from_attn_bias(b, 2), b.reshape(2, 4))
    assert key_bias_from_attn_bias(None, 2) is None
    with pytest.raises(ValueError, match="per-key"):
        key_bias_from_attn_bias(torch.zeros(2, 1, 4, 4), 2)
    on = {"sequence_parallel": True}
    assert not use_ring(treg.EmitContext(), on)
    assert not use_ring(treg.EmitContext(mesh=Mesh({"sp": 1})), on)
    assert not use_ring(treg.EmitContext(mesh=Mesh({"dp": 2, "sp": 2})), {})
    assert use_ring(treg.EmitContext(mesh=Mesh({"dp": 2, "sp": 2})), on)
