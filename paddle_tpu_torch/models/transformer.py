"""Transformer-base NMT (encoder-decoder): the network ``bench.py``'s
``bench_transformer`` trains, mirroring the reference's
dist_transformer.py (Transformer-base: 6+6 layers, d_model 512, 8 heads,
d_ff 2048, shared target embedding/projection, label smoothing).

Ported from the JAX package's ``models/transformer.py``: the same
functions emit the same Program (op types, attrs, parameter names) through
the port's ``fluid.layers``, so ``Scope.from_numpy`` carries a JAX
startup scope across by name.

- every attention (encoder self-attention with the source key bias,
  causal decoder self-attention, cross-attention over the encoder output
  with the source key bias) is the ``fused_multihead_attention`` op:
  the BSH flash kernels on the card where ``bsh_dispatch_ok`` holds
  (head dim 64/128/256, lengths multiples of 128), else the op's
  composition;
- ``fuse_stack`` builds the encoder and decoder as one
  ``fused_encoder_stack`` / ``fused_decoder_stack`` op each over stacked
  ``enc_stack.*`` / ``dec_stack.*`` parameters;
- sinusoid position encodings come from ``add_position_encoding``;
- static [B, S] shapes; padding is an additive -1e4 bias;
- label smoothing is analytic: (1 - eps) CE + eps (logsumexp - mean of
  the logits), through ``reduce_max``, ``exp``, ``log``, ``reduce_sum``
  and ``reduce_mean``, without a [B*St, V] one-hot.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from ..fluid import layers
from ..fluid.framework import Program, program_guard
from ..fluid.initializer import ConstantInitializer, NormalInitializer
from ..fluid.param_attr import ParamAttr


@dataclasses.dataclass
class TransformerConfig:
    src_vocab_size: int = 30000
    trg_vocab_size: int = 30000
    d_model: int = 512
    num_heads: int = 8
    d_inner: int = 2048
    n_encoder_layers: int = 6
    n_decoder_layers: int = 6
    dropout: float = 0.1
    label_smooth_eps: float = 0.1
    # one fused_encoder_stack / fused_decoder_stack op over stacked layer
    # params, flash kernels for self- AND cross-attention
    fuse_stack: bool = False

    @staticmethod
    def base() -> "TransformerConfig":
        return TransformerConfig()

    @staticmethod
    def tiny() -> "TransformerConfig":
        return TransformerConfig(
            src_vocab_size=64, trg_vocab_size=64, d_model=32, num_heads=4,
            d_inner=64, n_encoder_layers=2, n_decoder_layers=2)


def _fc3(x, size, pname, act=None):
    return layers.fc(
        x, size, num_flatten_dims=2,
        param_attr=ParamAttr(name=f"{pname}.w_0",
                             initializer=NormalInitializer(0.0, 0.02)),
        bias_attr=ParamAttr(name=f"{pname}.b_0",
                            initializer=ConstantInitializer(0.0)),
        act=act)


def _ln(x, name):
    return layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name=f"{name}_scale"),
        bias_attr=ParamAttr(name=f"{name}_bias"))


def _cross_attention(cfg, q3, kv, kv_bias, name, is_test):
    """Cross-attention (trg queries over src keys) through the fused
    attention op: the BSH flash kernels (rectangular lengths too) with the
    source padding bias as a per-key mask where ``bsh_dispatch_ok``
    holds, else the op's composition."""
    h = q3.shape[-1]
    q3 = _fc3(q3, h, f"{name}_query_fc")  # learned W_Q (dist_transformer
    k3 = _fc3(kv, h, f"{name}_key_fc")    # __compute_qkv projects q too)
    v3 = _fc3(kv, h, f"{name}_value_fc")
    return layers.fused_multihead_attention(
        q3, k3, v3, kv_bias, num_heads=cfg.num_heads,
        dropout_prob=cfg.dropout, is_test=is_test, causal=False)


def _self_attn_block(cfg, hidden, bias, name, is_test, causal):
    h = hidden.shape[-1]
    q = _fc3(hidden, h, f"{name}_q_fc")
    k = _fc3(hidden, h, f"{name}_k_fc")
    v = _fc3(hidden, h, f"{name}_v_fc")
    ctx = layers.fused_multihead_attention(
        q, k, v, bias, num_heads=cfg.num_heads, dropout_prob=cfg.dropout,
        is_test=is_test, causal=causal)
    out = _fc3(ctx, h, f"{name}_out_fc")
    if not is_test and cfg.dropout > 0:
        out = layers.dropout(out, cfg.dropout,
                             dropout_implementation="upscale_in_train")
    return _ln(layers.elementwise_add(hidden, out), f"{name}_post_ln")


def _ffn_block(cfg, hidden, name, is_test):
    h = hidden.shape[-1]
    inter = _fc3(hidden, cfg.d_inner, f"{name}_ffn_fc0", act="relu")
    out = _fc3(inter, h, f"{name}_ffn_fc1")
    if not is_test and cfg.dropout > 0:
        out = layers.dropout(out, cfg.dropout,
                             dropout_implementation="upscale_in_train")
    return _ln(layers.elementwise_add(hidden, out), f"{name}_ffn_ln")


def _embed(cfg, ids, vocab, emb_name, is_test):
    emb = layers.embedding(
        ids, size=[vocab, cfg.d_model],
        param_attr=ParamAttr(name=emb_name,
                             initializer=NormalInitializer(0.0, 0.02)))
    emb = layers.scale(emb, scale=cfg.d_model ** 0.5)
    emb = layers.add_position_encoding(emb, alpha=1.0, beta=1.0)
    if not is_test and cfg.dropout > 0:
        emb = layers.dropout(emb, cfg.dropout,
                             dropout_implementation="upscale_in_train")
    return emb


def _pad_bias(mask):
    """[B, S] 1/0 mask -> additive [B, 1, 1, S] bias."""
    bias = layers.scale(layers.cast(mask, "float32"), scale=1e4, bias=-1e4)
    return layers.unsqueeze(layers.unsqueeze(bias, [1]), [1])


def _stack_param(helper, name, shape, init=None):
    return helper.create_parameter(
        ParamAttr(name=name, initializer=init or NormalInitializer(0.0, 0.02)),
        shape=shape, dtype="float32")


def _fused_encoder_stack(cfg, hidden, bias, is_test):
    from ..fluid.layer_helper import LayerHelper
    from ..fluid.layers.nn import _rng_salt_counter

    L, h, f = cfg.n_encoder_layers, cfg.d_model, cfg.d_inner
    helper = LayerHelper("fused_encoder_stack")
    ones, zeros = ConstantInitializer(1.0), ConstantInitializer(0.0)
    p = {
        "QKVW": _stack_param(helper, "enc_stack.qkv_w", [L, h, 3 * h]),
        "QKVB": _stack_param(helper, "enc_stack.qkv_b", [L, 3 * h], zeros),
        "OutW": _stack_param(helper, "enc_stack.out_w", [L, h, h]),
        "OutB": _stack_param(helper, "enc_stack.out_b", [L, h], zeros),
        "Ln1S": _stack_param(helper, "enc_stack.ln1_s", [L, h], ones),
        "Ln1B": _stack_param(helper, "enc_stack.ln1_b", [L, h], zeros),
        "FfnW1": _stack_param(helper, "enc_stack.ffn_w1", [L, h, f]),
        "FfnB1": _stack_param(helper, "enc_stack.ffn_b1", [L, f], zeros),
        "FfnW2": _stack_param(helper, "enc_stack.ffn_w2", [L, f, h]),
        "FfnB2": _stack_param(helper, "enc_stack.ffn_b2", [L, h], zeros),
        "Ln2S": _stack_param(helper, "enc_stack.ln2_s", [L, h], ones),
        "Ln2B": _stack_param(helper, "enc_stack.ln2_b", [L, h], zeros),
    }
    out = helper.create_variable_for_type_inference("float32")
    _rng_salt_counter[0] += 1
    helper.append_op(
        type="fused_encoder_stack",
        inputs={"Hidden": [hidden], "AttnBias": [bias],
                **{k: [v] for k, v in p.items()}},
        outputs={"Out": [out]},
        attrs={"num_heads": cfg.num_heads, "act": "relu",
               "dropout_prob": cfg.dropout,
               "attn_dropout_prob": cfg.dropout, "is_test": is_test,
               "use_flash_attention": getattr(cfg, "use_flash", True),
               "rng_salt": _rng_salt_counter[0]},
    )
    return out


def _fused_decoder_stack(cfg, hidden, enc_out, src_bias, is_test):
    from ..fluid.layer_helper import LayerHelper
    from ..fluid.layers.nn import _rng_salt_counter

    L, h, f = cfg.n_decoder_layers, cfg.d_model, cfg.d_inner
    helper = LayerHelper("fused_decoder_stack")
    ones, zeros = ConstantInitializer(1.0), ConstantInitializer(0.0)

    def p_(name, shape, init=None):
        return _stack_param(helper, f"dec_stack.{name}", shape, init)

    p = {
        "SelfQKVW": p_("self_qkv_w", [L, h, 3 * h]),
        "SelfQKVB": p_("self_qkv_b", [L, 3 * h], zeros),
        "SelfOutW": p_("self_out_w", [L, h, h]),
        "SelfOutB": p_("self_out_b", [L, h], zeros),
        "Ln1S": p_("ln1_s", [L, h], ones),
        "Ln1B": p_("ln1_b", [L, h], zeros),
        "CrossQW": p_("cross_q_w", [L, h, h]),
        "CrossQB": p_("cross_q_b", [L, h], zeros),
        "CrossKW": p_("cross_k_w", [L, h, h]),
        "CrossKB": p_("cross_k_b", [L, h], zeros),
        "CrossVW": p_("cross_v_w", [L, h, h]),
        "CrossVB": p_("cross_v_b", [L, h], zeros),
        "CrossOutW": p_("cross_out_w", [L, h, h]),
        "CrossOutB": p_("cross_out_b", [L, h], zeros),
        "Ln2S": p_("ln2_s", [L, h], ones),
        "Ln2B": p_("ln2_b", [L, h], zeros),
        "FfnW1": p_("ffn_w1", [L, h, f]),
        "FfnB1": p_("ffn_b1", [L, f], zeros),
        "FfnW2": p_("ffn_w2", [L, f, h]),
        "FfnB2": p_("ffn_b2", [L, h], zeros),
        "Ln3S": p_("ln3_s", [L, h], ones),
        "Ln3B": p_("ln3_b", [L, h], zeros),
    }
    out = helper.create_variable_for_type_inference("float32")
    _rng_salt_counter[0] += 1
    helper.append_op(
        type="fused_decoder_stack",
        inputs={"Hidden": [hidden], "EncOut": [enc_out],
                "SrcBias": [src_bias], **{k: [v] for k, v in p.items()}},
        outputs={"Out": [out]},
        attrs={"num_heads": cfg.num_heads, "act": "relu",
               "dropout_prob": cfg.dropout,
               "attn_dropout_prob": cfg.dropout, "is_test": is_test,
               "use_flash_attention": getattr(cfg, "use_flash", True),
               "rng_salt": _rng_salt_counter[0]},
    )
    return out


def transformer_encoder(cfg, src_ids, src_mask, is_test=False):
    hidden = _embed(cfg, src_ids, cfg.src_vocab_size, "src_embedding", is_test)
    bias = _pad_bias(src_mask)
    if getattr(cfg, "fuse_stack", False):
        return _fused_encoder_stack(cfg, hidden, bias, is_test), bias
    for i in range(cfg.n_encoder_layers):
        hidden = _self_attn_block(cfg, hidden, bias, f"enc_{i}", is_test,
                                  causal=False)
        hidden = _ffn_block(cfg, hidden, f"enc_{i}", is_test)
    return hidden, bias


def transformer_decoder(cfg, trg_ids, enc_out, src_bias, is_test=False):
    hidden = _embed(cfg, trg_ids, cfg.trg_vocab_size, "trg_embedding", is_test)
    if getattr(cfg, "fuse_stack", False):
        return _fused_decoder_stack(cfg, hidden, enc_out, src_bias, is_test)
    for i in range(cfg.n_decoder_layers):
        hidden = _self_attn_block(cfg, hidden, None, f"dec_{i}", is_test,
                                  causal=True)
        cross = _cross_attention(cfg, hidden, enc_out, src_bias,
                                 f"dec_{i}_cross", is_test)
        cross_out = _fc3(cross, cfg.d_model, f"dec_{i}_cross_out_fc")
        if not is_test and cfg.dropout > 0:
            # residual-path dropout, like every other sublayer
            cross_out = layers.dropout(
                cross_out, cfg.dropout,
                dropout_implementation="upscale_in_train")
        hidden = _ln(layers.elementwise_add(hidden, cross_out),
                     f"dec_{i}_cross_ln")
        hidden = _ffn_block(cfg, hidden, f"dec_{i}", is_test)
    return hidden


def build_transformer_nmt_program(
    cfg: TransformerConfig, batch: int, src_len: int, trg_len: int,
    is_test: bool = False,
    main_program: Optional[Program] = None,
    startup_program: Optional[Program] = None,
):
    """Feeds: src_ids/trg_ids [B, S] int32, src_mask [B, S_src] float32,
    labels [B, S_trg, 1] int32, label_weights [B, S_trg, 1] float32.
    Returns (main, startup, feed_names, loss)."""
    main = main_program or Program()
    startup = startup_program or Program()
    with program_guard(main, startup):
        src_ids = layers.data("src_ids", [batch, src_len], dtype="int32",
                              append_batch_size=False)
        trg_ids = layers.data("trg_ids", [batch, trg_len], dtype="int32",
                              append_batch_size=False)
        src_mask = layers.data("src_mask", [batch, src_len], dtype="float32",
                               append_batch_size=False)
        labels = layers.data("labels", [batch, trg_len, 1], dtype="int32",
                             append_batch_size=False)
        label_weights = layers.data(
            "label_weights", [batch, trg_len, 1], dtype="float32",
            append_batch_size=False)

        enc_out, src_bias = transformer_encoder(cfg, src_ids, src_mask, is_test)
        dec_out = transformer_decoder(cfg, trg_ids, enc_out, src_bias, is_test)
        # shared target embedding as the output projection (weight tying);
        # logits stay flat [B*St, V] end to end: no [B, St, V] copy of the
        # largest tensor in the model
        trg_emb = main.global_block().var("trg_embedding")
        flat = layers.reshape(dec_out, [batch * trg_len, cfg.d_model])
        logits = layers.matmul(flat, trg_emb, transpose_y=True)
        labels_flat = layers.reshape(labels, [batch * trg_len, 1])
        weights_flat = layers.reshape(label_weights, [batch * trg_len, 1])

        # analytic label smoothing: with y_sm = (1-eps)*onehot + eps/K,
        # CE(y_sm) = (1-eps)*CE_hard + eps*(logsumexp - mean(logits)).
        # Same value as label_smooth + soft-label CE, without building
        # the [B*St, V] one-hot.
        eps_ls = float(cfg.label_smooth_eps)
        ce_hard = layers.softmax_with_cross_entropy(logits, labels_flat)
        if eps_ls > 0.0:
            mx = layers.reduce_max(logits, dim=-1, keep_dim=True)
            lse = layers.elementwise_add(
                layers.log(layers.reduce_sum(
                    layers.exp(layers.elementwise_sub(logits, mx)),
                    dim=-1, keep_dim=True)),
                mx)
            uniform_ce = layers.elementwise_sub(
                lse, layers.reduce_mean(logits, dim=-1, keep_dim=True))
            ce = layers.elementwise_add(
                layers.scale(ce_hard, scale=1.0 - eps_ls),
                layers.scale(uniform_ce, scale=eps_ls))
        else:
            ce = ce_hard
        ce = layers.elementwise_mul(ce, weights_flat)
        denom = layers.elementwise_add(
            layers.reduce_sum(label_weights),
            layers.fill_constant([1], "float32", 1e-6))
        loss = layers.elementwise_div(layers.reduce_sum(ce), denom)
    feeds = ["src_ids", "trg_ids", "src_mask", "labels", "label_weights"]
    return main, startup, feeds, loss


def transformer_step_flops(cfg: TransformerConfig, batch, src_len, trg_len):
    """fwd+bwd matmul FLOPs per step (6N per active-token parameter) +
    attention score/context terms. Cross-attention K/V projections run
    over SRC tokens; q/out projections run over TRG tokens."""
    h, f = cfg.d_model, cfg.d_inner
    ld = cfg.n_decoder_layers
    # per src token: encoder qkv+out+ffn, plus decoder cross K/V proj
    enc_tok = (6 * cfg.n_encoder_layers * (4 * h * h + 2 * h * f)
               + 12 * cfg.n_encoder_layers * src_len * h
               + 6 * ld * (2 * h * h))
    # per trg token: decoder self qkv+out, cross q+out, ffn, vocab proj,
    # self-attn over trg_len + cross-attn over src_len
    dec_tok = (6 * ld * (4 * h * h + 2 * h * h + 2 * h * f)
               + 6 * cfg.trg_vocab_size * h
               + 12 * ld * (trg_len + src_len) * h)
    return batch * (src_len * enc_tok + trg_len * dec_tok)


def random_nmt_batch(cfg: TransformerConfig, batch, src_len, trg_len, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    return {
        "src_ids": rng.randint(0, cfg.src_vocab_size,
                               (batch, src_len)).astype(np.int32),
        "trg_ids": rng.randint(0, cfg.trg_vocab_size,
                               (batch, trg_len)).astype(np.int32),
        "src_mask": np.ones((batch, src_len), np.float32),
        "labels": rng.randint(0, cfg.trg_vocab_size,
                              (batch, trg_len, 1)).astype(np.int32),
        "label_weights": np.ones((batch, trg_len, 1), np.float32),
    }
