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


# the kernel's split: per-chunk partials merged in chunk order
# (paged_attention_split_reference), against the JAX package's dense
# reference.  Pages of 16 make chunks of 4 pages (64 positions).
SPLIT_CASES = {
    # 1, a chunk boundary and one past it and one short of it, a length
    # on the table's full reach (16 pages) and past it, length 0 last
    "ragged_mha": dict(b=8, h=4, kh=4, d=64, page=16, npages=40, maxp=16,
                       lens=[1, 63, 64, 65, 128, 256, 300, 129]),
    "gqa_kh4_of_12": dict(b=5, h=12, kh=4, d=64, page=16, npages=40,
                          maxp=16, lens=[1, 64, 65, 256, 999]),
    "d128_gqa": dict(b=3, h=8, kh=2, d=128, page=8, npages=30, maxp=12,
                     lens=[1, 64, 96]),
    "d256": dict(b=3, h=2, kh=2, d=256, page=16, npages=20, maxp=5,
                 lens=[80, 63, 81]),
}


def _jax_ref(x):
    from paddle_tpu.ops.pallas.paged_attention import _ref_paged_attention

    d = x["q"].shape[-1]
    return np.asarray(_ref_paged_attention(
        *(jnp.asarray(x[k]) for k in ("q", "kp", "vp", "tbl", "lens")),
        1.0 / np.sqrt(d)))


def _split(x, chunk=None):
    return pa.paged_attention_split_reference(
        *(torch.as_tensor(x[k]) for k in ("q", "kp", "vp", "tbl", "lens")),
        chunk=chunk).numpy()


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_reference_matches_jax_reference(case):
    x = _inputs(6, **SPLIT_CASES[case])
    np.testing.assert_allclose(_split(x), _jax_ref(x), atol=1e-6, rtol=0)


@pytest.mark.parametrize("chunk", [1, 2, 3, 16, 40])
def test_split_reference_any_chunk_matches_jax_reference(chunk):
    """Chunks of one page, of a count that leaves the last chunk short,
    of the whole table and wider than it."""
    x = _inputs(7, **SPLIT_CASES["ragged_mha"])
    np.testing.assert_allclose(_split(x, chunk), _jax_ref(x), atol=1e-6,
                               rtol=0)


def test_split_reference_gives_zero_at_length_zero():
    x = _inputs(8, **dict(SPLIT_CASES["ragged_mha"],
                          lens=[0, 5, 0, 64, 1, 0, 2, 3]))
    got = _split(x)
    assert not got[[0, 2, 5]].any()
    live = [1, 3, 4, 6, 7]
    np.testing.assert_allclose(got[live], _jax_ref(x)[live], atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("h,kh,maxp,page,want", [
    (12, 12, 64, 16, (4, 16, 1, 1)),     # the decode step's shape
    (12, 4, 64, 16, (4, 16, 4, 1)),      # GQA: 3 heads a kv head
    (8, 2, 8, 16, (4, 2, 4, 1)),
    (4, 4, 6, 8, (8, 1, 1, 1)),          # the whole table in one chunk
    (16, 8, 10, 128, (1, 10, 2, 1)),     # a page longer than a chunk
    (64, 2, 33, 1, (64, 1, 32, 1)),      # 32 heads a kv head
    (96, 1, 7, 32, (2, 4, 32, 3)),       # 96: three head groups
    (40, 8, 5, 64, (1, 5, 8, 1)),
])
def test_split_geometry(h, kh, maxp, page, want):
    """Chunks of whole pages up to 64 positions, as many as the table's
    width needs; the narrowest warp split that holds a kv head's query
    heads, at most 32 a block."""
    chunk_pages, nchunks, hpb, hgroups = got = pa.split_geometry(
        h, kh, maxp, page)
    assert got == want
    assert chunk_pages * page <= max(pa.CHUNK_POSITIONS, page)
    assert (nchunks - 1) * chunk_pages < maxp <= nchunks * chunk_pages
    assert hpb in pa.HEADS_PER_BLOCK and hpb * hgroups >= h // kh


def test_split_workspace_is_cached_per_device_and_stream(monkeypatch):
    monkeypatch.setattr(pa, "_workspaces", {})
    part, ticket = pa.split_workspace("cpu", 7, 1000, 96)
    assert part.shape == (1000,) and part.dtype == torch.float32
    assert ticket.shape == (96,) and ticket.dtype == torch.int32
    assert not ticket.any()  # zero before the first call
    again = pa.split_workspace(torch.device("cpu"), 7, 500, 12)
    assert again[0] is part and again[1] is ticket  # smaller: reused
    assert pa.split_workspace("cpu", 8, 1000, 96)[0] is not part
    grown = pa.split_workspace("cpu", 7, 2000, 12)
    assert grown[0].shape == (2000,) and grown[1].shape == (96,)
    assert pa.split_workspace("cpu", 7, 1000, 96)[0] is grown[0]


class _HostReadForbidden(torch.Tensor):
    """lengths as the decode step hands it over: a device tensor whose
    values the wrapper must not read on the host."""

    def _refuse(self, *a, **k):
        raise AssertionError("the wrapper read lengths on the host")

    item = tolist = numpy = cpu = __int__ = __index__ = __bool__ = _refuse
    __float__ = __iter__ = __getitem__ = _refuse


class _Dev:
    def __init__(self, *a):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _Stream:
    cuda_stream = 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_passes_the_split_and_never_reads_lengths(dtype,
                                                         monkeypatch):
    """On the card a call is one ``paged_attention_launch`` with
    ``split_geometry``'s split and the cached workspace; lengths goes over
    as a pointer and is never read on the host (no .item()/.tolist(): no
    sync).  A failed launch raises and counts nothing: nothing retries
    it on the plain version."""
    monkeypatch.setattr(torch.cuda, "device", _Dev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(pa, "_workspaces", {})
    calls = []
    monkeypatch.setattr(pa, "_launcher", lambda: lambda *a: (
        calls.append(a) or 0))
    x = _inputs(9, b=8, h=12, kh=4, d=64, page=16, npages=40, maxp=64,
                lens=[1, 37, 1024, 300, 513, 64, 777, 129])
    q, kp, vp, tbl = (torch.as_tensor(x[k]).to(dtype) if k != "tbl"
                      else torch.as_tensor(x[k])
                      for k in ("q", "kp", "vp", "tbl"))
    lens = torch.Tensor._make_subclass(_HostReadForbidden,
                                       torch.as_tensor(x["lens"]))
    n0 = pa.paged_attention.launches
    out = pa._cuda_paged_attention(q, kp, vp, tbl, lens, 0.125)
    args, = calls
    assert len(args) == 19
    part, ticket = pa._workspaces[(torch.device("cpu"), 5)]
    assert args[4] == lens.data_ptr() and args[5] == out.data_ptr()
    assert args[6:8] == (part.data_ptr(), ticket.data_ptr())
    assert args[8:16] == (8, 12, 4, 64, 16, 64, 4, 4)
    assert args[16] == 0.125 and args[17] == pa._DTYPE_CODES[dtype]
    assert args[18] == 5
    assert part.numel() == 8 * 12 * 16 * 66 and ticket.numel() == 8 * 4
    assert out.dtype == dtype and out.shape == q.shape
    assert pa.paged_attention.launches == n0 + 1

    monkeypatch.setattr(pa, "_launcher", lambda: lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        pa._cuda_paged_attention(q, kp, vp, tbl, lens, 0.125)
    assert pa.paged_attention.launches == n0 + 1


def test_launch_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(pa, "_launcher", lambda: pytest.fail("launched"))
    x = _inputs(10, **MHA_CASES["d64"])
    q, kp, vp, tbl, lens = (torch.as_tensor(x[k]) for k in
                            ("q", "kp", "vp", "tbl", "lens"))
    for bad in (dict(q=q.double()), dict(lens=lens.long()),
                dict(kp=kp[:, :, :1]), dict(q=q[:, :, :32].contiguous())):
        kw = dict(q=q, kp=kp, vp=vp, tbl=tbl, lens=lens)
        kw.update(bad)
        with pytest.raises(ValueError):
            pa._cuda_paged_attention(kw["q"], kw["kp"], kw["vp"], kw["tbl"],
                                     kw["lens"], 0.125)
