"""The port's decoder LM against the JAX package's, function by function,
on the same numpy weights and inputs.

Tolerances: logits and computed K/V atol = rtol = 1e-5 (both f32; XLA
and torch sum matmuls and softmaxes in different orders).  Pure data
movement (gather_ctx, scatter_kv, copy_page, params round trip) is
compared exactly.  Argmax tokens are compared exactly: both frameworks
pick the first maximal index and these seeds leave no near-ties.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference import decode_model as jdm
from paddle_tpu_torch.inference import decode_model as tdm

TOL = dict(atol=1e-5, rtol=1e-5)

# the default toy config and test_kv_serving's d=128 drill config
CONFIGS = {
    "default": dict(),
    "d128": dict(vocab=128, d_model=128, n_layers=2, n_heads=4, ffn=256,
                 max_seq=256),
}


def _cfgs(name):
    kw = CONFIGS[name]
    return jdm.DecoderConfig(**kw), tdm.DecoderConfig(**kw)


def _params(name, seed=0):
    jcfg, tcfg = _cfgs(name)
    np_params = jdm.init_params(jcfg, seed)
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    tp = tdm.params_from_numpy(np_params, "cpu")
    return jcfg, jp, tp


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _pool(cfg, n_pages, page, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, n_pages * page, cfg.n_heads, cfg.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_same_weights_and_round_trip(name):
    jcfg, tcfg = _cfgs(name)
    a, b = jdm.init_params(jcfg, 7), tdm.init_params(tcfg, 7)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    back = {k: v.cpu().numpy()
            for k, v in tdm.params_from_numpy(b, "cpu").items()}
    for k in a:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], a[k])
    # the reference model's device params carry across through numpy
    jm = jdm.TinyDecoderLM(jcfg, seed=3)
    tm = tdm.TinyDecoderLM(
        tcfg, params={k: np.asarray(v) for k, v in jm.params.items()},
        device="cpu")
    for k in jm.params:
        np.testing.assert_array_equal(tm.params[k].numpy(),
                                      np.asarray(jm.params[k]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_matches_jax(name):
    """A window of 11 live rows (padded to 16) after 8 cached context
    positions gathered through a page table."""
    cfg, jp, tp = _params(name)
    page, n_pages = 4, 2 + cfg.max_seq // 4
    k_np, v_np = _pool(cfg, n_pages, page, seed=1)
    rng = np.random.default_rng(2)
    table = np.zeros(cfg.max_seq // page, np.int32)
    table[:2] = [5, 9]
    window = np.zeros(16, np.int32)
    window[:11] = rng.integers(1, cfg.vocab, 11)
    jctx = jdm.gather_ctx(jnp.asarray(k_np), jnp.asarray(v_np),
                          jnp.asarray(table), page_size=page)
    tctx = tdm.gather_ctx(_t(k_np), _t(v_np), _t(table), page_size=page)
    jl, jt, jk, jv = jdm.prefill(jp, jnp.asarray(window), jnp.int32(8),
                                 *jctx, jnp.int32(11),
                                 n_heads=cfg.n_heads)
    tl, tt, tk, tv = tdm.prefill(tp, _t(window), 8, *tctx, 11,
                                 n_heads=cfg.n_heads)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(tt) == int(jt)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_step_matches_jax(name):
    """Three slots — two live with ragged positions, one dead on trash
    page 0 — through the paged-attention op; logits, tokens and the
    updated pool."""
    cfg, jp, tp = _params(name)
    page, n_pages = 4, 16
    k_np, v_np = _pool(cfg, n_pages, page, seed=3)
    maxp = -(-cfg.max_seq // page)
    table = np.zeros((3, maxp), np.int32)
    table[0, :3] = [2, 7, 11]       # position 9 -> page 7 offset 1
    table[1, :1] = [4]              # position 2 -> page 4 offset 2
    tokens = np.asarray([5, 17, 0], np.int32)
    positions = np.asarray([9, 2, 0], np.int32)
    write = np.asarray([7 * page + 1, 4 * page + 2, 0], np.int32)
    jl, jn, jk, jv = jdm.decode_step(
        jp, jnp.asarray(k_np), jnp.asarray(v_np), jnp.asarray(tokens),
        jnp.asarray(positions), jnp.asarray(table), jnp.asarray(write),
        page_size=page, n_heads=cfg.n_heads)
    tk_in, tv_in = _t(k_np).clone(), _t(v_np).clone()
    tl, tn, tk, tv = tdm.decode_step(
        tp, tk_in, tv_in, _t(tokens), _t(positions), _t(table), _t(write),
        page_size=page, n_heads=cfg.n_heads)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    # the pool is updated in place and handed back
    assert tk.data_ptr() == tk_in.data_ptr()
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    untouched = np.ones(k_np.shape[1], bool)
    untouched[write] = False
    np.testing.assert_array_equal(tk.numpy()[:, untouched],
                                  k_np[:, untouched])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_recompute_step_matches_jax(name):
    cfg, jp, tp = _params(name)
    rng = np.random.default_rng(4)
    s = min(cfg.max_seq, 32)
    tokens = rng.integers(0, cfg.vocab, (3, s)).astype(np.int32)
    lengths = np.asarray([s, 5, 1], np.int32)
    jl, jn = jdm.recompute_step(jp, jnp.asarray(tokens),
                                jnp.asarray(lengths), n_heads=cfg.n_heads)
    tl, tn = tdm.recompute_step(tp, _t(tokens), _t(lengths),
                                n_heads=cfg.n_heads)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_decode_equals_dense_forward(name):
    """Teacher-forced prefill + decode steps through the paged path
    reproduce the dense recompute forward's logits at every step (the
    same check chip_smoke.py makes on the card)."""
    cfg, _, tp = _params(name)
    page = 4
    maxp = cfg.max_seq // page
    rng = np.random.default_rng(5)
    seq = rng.integers(1, cfg.vocab, 13).astype(np.int32)
    k = torch.zeros(cfg.n_layers, (maxp + 1) * page, cfg.n_heads,
                    cfg.head_dim)
    v = torch.zeros_like(k)
    pages = list(range(1, maxp + 1))
    table = np.zeros((1, maxp), np.int32)
    table[0] = pages
    window = np.zeros(8, np.int32)
    window[:6] = seq[:6]
    ctx = tdm.gather_ctx(k, v, _t(table[0]), page_size=page)
    logits, _, kw, vw = tdm.prefill(tp, _t(window), 0, *ctx, 6,
                                    n_heads=cfg.n_heads)
    flat = np.zeros(8, np.int32)
    flat[:6] = [pages[i // page] * page + i % page for i in range(6)]
    tdm.scatter_kv(k, v, kw, vw, _t(flat))
    for pos in range(6, len(seq) + 1):
        dense, _ = tdm.recompute_step(tp, _t(seq[None, :pos]),
                                      _t(np.asarray([pos], np.int32)),
                                      n_heads=cfg.n_heads)
        np.testing.assert_allclose(logits.reshape(-1).numpy(),
                                   dense[0].numpy(), **TOL)
        if pos == len(seq):
            break
        logits, _, _, _ = tdm.decode_step(
            tp, k, v, _t(seq[pos:pos + 1]),
            _t(np.asarray([pos], np.int32)), _t(table),
            _t(np.asarray([pages[pos // page] * page + pos % page],
                          np.int32)),
            page_size=page, n_heads=cfg.n_heads)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gather_scatter_copy_page_exact(name):
    cfg, _ = _cfgs(name)
    page, n_pages = 4, 12
    k_np, v_np = _pool(cfg, n_pages, page, seed=6)
    rng = np.random.default_rng(7)
    # gather: a table with a repeated page and trailing trash entries
    table = np.asarray([3, 3, 8, 0, 0], np.int32)
    jk, jv = jdm.gather_ctx(jnp.asarray(k_np), jnp.asarray(v_np),
                            jnp.asarray(table), page_size=page)
    tk, tv = tdm.gather_ctx(_t(k_np), _t(v_np), _t(table), page_size=page)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # scatter: distinct rows (a repeated row's winner is unspecified in
    # both frameworks)
    rows = rng.permutation(n_pages * page)[:6].astype(np.int32)
    shape = (cfg.n_layers, 6, cfg.n_heads, cfg.head_dim)
    kw = rng.standard_normal(shape).astype(np.float32)
    vw = rng.standard_normal(shape).astype(np.float32)
    jk, jv = jdm.scatter_kv(jnp.asarray(k_np), jnp.asarray(v_np),
                            jnp.asarray(kw), jnp.asarray(vw),
                            jnp.asarray(rows))
    tk, tv = tdm.scatter_kv(_t(k_np).clone(), _t(v_np).clone(), _t(kw),
                            _t(vw), _t(rows))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # copy_page: page 2 -> page 9
    jk, jv = jdm.copy_page(jnp.asarray(k_np), jnp.asarray(v_np),
                           jnp.int32(2), jnp.int32(9), page_size=page)
    tk, tv = tdm.copy_page(_t(k_np).clone(), _t(v_np).clone(), 2, 9,
                           page_size=page)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_prefill_bucket_matches_jax():
    for n in (1, 7, 8, 9, 100, 512, 513):
        assert tdm.prefill_bucket(n) == jdm.prefill_bucket(n)


def test_adopt_keeps_shape_checks():
    cfg = tdm.DecoderConfig()
    m = tdm.TinyDecoderLM(cfg, seed=0, device="cpu")
    with pytest.raises(KeyError):
        m.adopt({"nope": np.zeros(3, np.float32)})
    with pytest.raises(ValueError):
        m.adopt({"head": np.zeros((3, 3), np.float32)})
    new = m.params["head"].numpy() * 0.5
    m.adopt({"head": new})
    np.testing.assert_array_equal(m.params["head"].numpy(), new)
    assert m.params["head"].device.type == "cpu"
