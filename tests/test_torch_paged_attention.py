"""The port's paged attention (plain PyTorch version, the one CPU tensors
take) against the JAX package's: the Pallas kernel in interpret mode and
the dense ``jnp`` reference, on the same numpy inputs.

Tolerances: f32 2e-6 (the same dense math; XLA and torch sum in other
orders).  bf16 rtol 2**-7 (both round the same f32 value to bf16; a
last-bit difference in f32 can straddle a rounding boundary, which moves
the result by one bf16 ulp, at most 2**-7 relative).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.paged_attention import paged_attention as jax_pa
from paddle_tpu_torch.ops.kernels import paged_attention as pa

F32_TOL = 2e-6


def _inputs(seed, b, h, kh, d, page, npages, maxp, lens):
    rng = np.random.default_rng(seed)
    return dict(
        q=rng.standard_normal((b, h, d)).astype(np.float32),
        kp=rng.standard_normal((npages, page, kh, d)).astype(np.float32),
        vp=rng.standard_normal((npages, page, kh, d)).astype(np.float32),
        tbl=rng.integers(0, npages, (b, maxp)).astype(np.int32),
        lens=np.asarray(lens, np.int32))


def _run_jax(x, impl, dtype=jnp.float32):
    out = jax_pa(jnp.asarray(x["q"], dtype), jnp.asarray(x["kp"], dtype),
                 jnp.asarray(x["vp"], dtype), jnp.asarray(x["tbl"]),
                 jnp.asarray(x["lens"]), impl=impl)
    return np.asarray(out.astype(jnp.float32))


def _run_torch(x, dtype=torch.float32, **kw):
    out = pa.paged_attention(
        torch.as_tensor(x["q"]).to(dtype), torch.as_tensor(x["kp"]).to(dtype),
        torch.as_tensor(x["vp"]).to(dtype), torch.as_tensor(x["tbl"]),
        torch.as_tensor(x["lens"]), **kw)
    assert out.dtype == dtype and out.device.type == "cpu"
    return out.float().numpy()


# test_kv_serving's kernel shapes and lengths, and the serving head size
MHA_CASES = {
    "kv_serving_d16": dict(b=3, h=4, kh=4, d=16, page=8, npages=10, maxp=4,
                           lens=[5, 17, 32]),
    "d64": dict(b=3, h=2, kh=2, d=64, page=16, npages=12, maxp=4,
                lens=[1, 16, 50]),
}


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_plain_matches_jax(case, impl):
    x = _inputs(0, **MHA_CASES[case])
    np.testing.assert_allclose(_run_torch(x), _run_jax(x, impl),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("d", [16, 64])
def test_gqa_matches_jax_reference(d):
    """Grouped-query heads (KH < H): the JAX package serves them only
    through its jnp reference."""
    x = _inputs(1, b=3, h=8, kh=2, d=d, page=8, npages=10, maxp=4,
                lens=[5, 17, 32])
    np.testing.assert_allclose(_run_torch(x), _run_jax(x, "jnp"),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_bf16_inputs_match_jax_reference(case):
    x = _inputs(2, **MHA_CASES[case])
    np.testing.assert_allclose(
        _run_torch(x, dtype=torch.bfloat16),
        _run_jax(x, "jnp", dtype=jnp.bfloat16), atol=1e-6, rtol=2 ** -7)


def test_impl_torch_and_explicit_scale_match_jax():
    x = _inputs(3, **MHA_CASES["d64"])
    ref = np.asarray(jax_pa(
        jnp.asarray(x["q"]), jnp.asarray(x["kp"]), jnp.asarray(x["vp"]),
        jnp.asarray(x["tbl"]), jnp.asarray(x["lens"]), sm_scale=0.3,
        impl="jnp"))
    np.testing.assert_allclose(_run_torch(x, impl="torch", sm_scale=0.3),
                               ref, atol=F32_TOL, rtol=F32_TOL)


def test_cpu_dispatch_never_counts_a_launch():
    x = _inputs(4, **MHA_CASES["d64"])
    before = pa.paged_attention.launches
    _run_torch(x)
    assert pa.paged_attention.launches == before


@pytest.mark.parametrize("impl", ["cuda", "pallas"])
def test_cpu_tensors_refuse_kernel_and_unknown_impls(impl):
    """Only None and "torch" are impl values: any other name raises
    rather than pick an implementation silently."""
    x = _inputs(5, **MHA_CASES["d64"])
    with pytest.raises(ValueError):
        _run_torch(x, impl=impl)


def test_bound_bytes_counts_live_pages_only():
    # lengths 1, 16, 17 at page 16 -> 34 K/V rows over 1 + 1 + 2 live
    # pages; a length past the table's reach (4 pages) counts 64 rows
    q = torch.zeros(4, 2, 64)
    kp = torch.zeros(10, 16, 2, 64)
    tbl = torch.zeros(4, 4, dtype=torch.int32)
    lens = torch.tensor([1, 16, 17, 999], dtype=torch.int32)
    row = 2 * 64 * 2 * 4                  # K+V of one position, 2 heads
    assert pa.bound_bytes(q, kp, tbl, lens) == (
        (1 + 16 + 17 + 64) * row + 4 * (1 + 1 + 2 + 4) + 4 * 4
        + 2 * q.numel() * 4)
