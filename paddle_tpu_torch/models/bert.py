"""BERT/ERNIE-base encoder + pretraining heads.

Ported from the JAX package's ``models/bert.py``: the same functions
emit the same Program (op types, attrs, parameter names) through the port's
``fluid.layers``.  The attention core is the ``fused_multihead_attention``
op (flash-attention kernel on the card) when
``config.use_flash_attention`` is set; every post-LN ``layer_norm`` runs
the add+LN kernel.

Not ported yet: ``fuse_stack=True`` (the scanned ``fused_encoder_stack``
op, training slice) and ``moe_num_experts > 0`` (``moe_ffn``, the
distributed slice); both raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from ..fluid import layers
from ..fluid.framework import Program, program_guard
from ..fluid.initializer import ConstantInitializer, TruncatedNormalInitializer
from ..fluid.param_attr import ParamAttr


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    use_flash_attention: bool = True
    # the scanned encoder stack and MoE FFN of the JAX package: both
    # raise here until their slices land
    fuse_stack: bool = False
    moe_num_experts: int = 0

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny() -> "BertConfig":
        """For tests / dryruns."""
        return BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=64,
                          max_position_embeddings=64)


def _winit(cfg):
    return ParamAttr(initializer=TruncatedNormalInitializer(
        scale=cfg.initializer_range))


def encoder_layer(cfg: BertConfig, hidden, attn_bias, name: str,
                  is_test: bool):
    """One post-LN transformer block: MHA + FFN, residuals, layer_norm.

    hidden: [B, S, H]; attn_bias: [B, 1, 1, S] additive (-1e4 * (1-mask)).
    """
    if cfg.moe_num_experts > 0:
        raise NotImplementedError(
            "moe_num_experts > 0: the moe_ffn op is not ported yet (the "
            "distributed slice brings it)")
    b, s, h = hidden.shape
    nh = cfg.num_attention_heads
    dh = h // nh

    def _fc3(x, size, pname, act=None):
        return layers.fc(
            x, size, num_flatten_dims=2,
            param_attr=ParamAttr(
                name=f"{pname}.w_0",
                initializer=TruncatedNormalInitializer(
                    scale=cfg.initializer_range)),
            bias_attr=ParamAttr(name=f"{pname}.b_0",
                                initializer=ConstantInitializer(0.0)),
            act=act)

    q = _fc3(hidden, h, f"{name}_query_fc")
    k = _fc3(hidden, h, f"{name}_key_fc")
    v = _fc3(hidden, h, f"{name}_value_fc")

    if cfg.use_flash_attention:
        ctx_layer = layers.fused_multihead_attention(
            q, k, v, attn_bias, num_heads=nh,
            dropout_prob=cfg.attention_probs_dropout_prob, is_test=is_test)
    else:
        def _split_heads(x):
            x = layers.reshape(x, [b, s, nh, dh])
            return layers.transpose(x, [0, 2, 1, 3])

        q, k, v = _split_heads(q), _split_heads(k), _split_heads(v)
        scores = layers.matmul(q, k, transpose_y=True,
                               alpha=1.0 / math.sqrt(dh))
        scores = layers.elementwise_add(scores, attn_bias)
        probs = layers.softmax(scores, axis=-1)
        if not is_test and cfg.attention_probs_dropout_prob > 0:
            probs = layers.dropout(
                probs, cfg.attention_probs_dropout_prob,
                dropout_implementation="upscale_in_train")
        ctx_layer = layers.matmul(probs, v)
        ctx_layer = layers.transpose(ctx_layer, [0, 2, 1, 3])
        ctx_layer = layers.reshape(ctx_layer, [b, s, h])

    attn_out = _fc3(ctx_layer, h, f"{name}_output_fc")
    if not is_test and cfg.hidden_dropout_prob > 0:
        attn_out = layers.dropout(attn_out, cfg.hidden_dropout_prob,
                                  dropout_implementation="upscale_in_train")
    attn_out = layers.layer_norm(
        layers.elementwise_add(hidden, attn_out), begin_norm_axis=2,
        param_attr=ParamAttr(name=f"{name}_post_att_ln_scale"),
        bias_attr=ParamAttr(name=f"{name}_post_att_ln_bias"))

    inter = _fc3(attn_out, cfg.intermediate_size, f"{name}_ffn_fc_0",
                 act=cfg.hidden_act)
    ffn_out = _fc3(inter, h, f"{name}_ffn_fc_1")
    if not is_test and cfg.hidden_dropout_prob > 0:
        ffn_out = layers.dropout(ffn_out, cfg.hidden_dropout_prob,
                                 dropout_implementation="upscale_in_train")
    return layers.layer_norm(
        layers.elementwise_add(attn_out, ffn_out), begin_norm_axis=2,
        param_attr=ParamAttr(name=f"{name}_post_ffn_ln_scale"),
        bias_attr=ParamAttr(name=f"{name}_post_ffn_ln_bias"))


def bert_encoder(cfg: BertConfig, input_ids, token_type_ids, position_ids,
                 input_mask, is_test: bool = False):
    """Embeddings + transformer stack. Returns sequence_output [B, S, H]."""
    emb = layers.embedding(
        input_ids, size=[cfg.vocab_size, cfg.hidden_size],
        param_attr=ParamAttr(name="word_embedding",
                             initializer=_winit(cfg).initializer))
    pos_emb = layers.embedding(
        position_ids, size=[cfg.max_position_embeddings, cfg.hidden_size],
        param_attr=ParamAttr(name="pos_embedding",
                             initializer=_winit(cfg).initializer))
    type_emb = layers.embedding(
        token_type_ids, size=[cfg.type_vocab_size, cfg.hidden_size],
        param_attr=ParamAttr(name="sent_embedding",
                             initializer=_winit(cfg).initializer))
    emb = layers.elementwise_add(layers.elementwise_add(emb, pos_emb),
                                 type_emb)
    emb = layers.layer_norm(
        emb, begin_norm_axis=2,
        param_attr=ParamAttr(name="pre_encoder_ln_scale"),
        bias_attr=ParamAttr(name="pre_encoder_ln_bias"))
    if not is_test and cfg.hidden_dropout_prob > 0:
        emb = layers.dropout(emb, cfg.hidden_dropout_prob,
                             dropout_implementation="upscale_in_train")

    # additive attention bias [B, 1, 1, S]: 0 where attend, -1e4 where pad
    mask_f = layers.cast(input_mask, "float32")
    attn_bias = layers.scale(mask_f, scale=1e4, bias=-1e4)  # 1e4*(mask-1)
    attn_bias = layers.unsqueeze(layers.unsqueeze(attn_bias, [1]), [1])

    if cfg.fuse_stack:
        raise NotImplementedError(
            "fuse_stack=True: the fused_encoder_stack op is not ported yet "
            "(the BERT training slice brings it); use fuse_stack=False")
    hidden = emb
    for i in range(cfg.num_hidden_layers):
        hidden = encoder_layer(cfg, hidden, attn_bias, f"encoder_layer_{i}",
                               is_test)
    return hidden


def bert_pooler(cfg: BertConfig, sequence_output):
    """tanh FC over the [CLS] (first) token."""
    b, s, h = sequence_output.shape
    first = layers.slice(sequence_output, axes=[1], starts=[0], ends=[1])
    first = layers.reshape(first, [b, h])
    return layers.fc(
        first, h,
        param_attr=ParamAttr(name="pooled_fc.w_0",
                             initializer=_winit(cfg).initializer),
        bias_attr=ParamAttr(name="pooled_fc.b_0"), act="tanh")


def build_bert_pretrain_program(cfg: BertConfig, batch_size: int,
                                seq_len: int, max_preds: int,
                                is_test: bool = False,
                                main_program: Optional[Program] = None,
                                startup_program: Optional[Program] = None):
    """Full MLM + NSP pretraining graph (static shapes).

    Returns (main_program, startup_program, feed_names, loss_var).
    Feeds: input_ids/token_type_ids/position_ids [B, S] int32,
    input_mask [B, S] float32, mask_positions [B*max_preds] int32 (flat
    indices into [B*S]), mask_labels [B*max_preds, 1] int32,
    mask_weights [B*max_preds, 1] float32, nsp_labels [B, 1] int32.
    """
    main = main_program or Program()
    startup = startup_program or Program()
    with program_guard(main, startup):
        def data(name, shape, dtype):
            return layers.data(name, shape=shape, dtype=dtype,
                               append_batch_size=False)

        input_ids = data("input_ids", [batch_size, seq_len], "int32")
        token_type_ids = data("token_type_ids", [batch_size, seq_len],
                              "int32")
        position_ids = data("position_ids", [batch_size, seq_len], "int32")
        input_mask = data("input_mask", [batch_size, seq_len], "float32")
        mask_positions = data("mask_positions", [batch_size * max_preds],
                              "int32")
        mask_labels = data("mask_labels", [batch_size * max_preds, 1],
                           "int32")
        mask_weights = data("mask_weights", [batch_size * max_preds, 1],
                            "float32")
        nsp_labels = data("nsp_labels", [batch_size, 1], "int32")

        seq_out = bert_encoder(cfg, input_ids, token_type_ids, position_ids,
                               input_mask, is_test=is_test)
        pooled = bert_pooler(cfg, seq_out)

        # ---- masked LM head (tied to word embedding, transform + bias) ----
        flat = layers.reshape(seq_out, [batch_size * seq_len,
                                        cfg.hidden_size])
        picked = layers.gather(flat, mask_positions)  # [B*max_preds, H]
        trans = layers.fc(
            picked, cfg.hidden_size,
            param_attr=ParamAttr(name="mask_lm_trans_fc.w_0",
                                 initializer=_winit(cfg).initializer),
            bias_attr=ParamAttr(name="mask_lm_trans_fc.b_0"),
            act=cfg.hidden_act)
        trans = layers.layer_norm(
            trans, begin_norm_axis=1,
            param_attr=ParamAttr(name="mask_lm_trans_ln_scale"),
            bias_attr=ParamAttr(name="mask_lm_trans_ln_bias"))
        word_emb = main.global_block().var("word_embedding")
        logits = layers.matmul(trans, word_emb, transpose_y=True)
        out_bias = layers.create_parameter(
            shape=[cfg.vocab_size], dtype="float32", name="mask_lm_out_fc.b_0",
            default_initializer=ConstantInitializer(0.0))
        logits = layers.elementwise_add(logits, out_bias)
        mlm_loss = layers.softmax_with_cross_entropy(logits, mask_labels)
        mlm_loss = layers.elementwise_mul(mlm_loss, mask_weights)
        denom = layers.reduce_sum(mask_weights)
        denom = layers.elementwise_add(
            denom, layers.fill_constant(shape=[1], dtype="float32",
                                        value=1e-5))
        mlm_loss = layers.elementwise_div(layers.reduce_sum(mlm_loss), denom)

        # ---- next-sentence head ----
        nsp_logits = layers.fc(
            pooled, 2,
            param_attr=ParamAttr(name="next_sent_fc.w_0",
                                 initializer=_winit(cfg).initializer),
            bias_attr=ParamAttr(name="next_sent_fc.b_0"))
        nsp_loss = layers.reduce_mean(
            layers.softmax_with_cross_entropy(nsp_logits, nsp_labels))
        loss = layers.elementwise_add(mlm_loss, nsp_loss)

    feed_names = ["input_ids", "token_type_ids", "position_ids", "input_mask",
                  "mask_positions", "mask_labels", "mask_weights",
                  "nsp_labels"]
    return main, startup, feed_names, loss


def random_pretrain_batch(cfg: BertConfig, batch_size: int, seq_len: int,
                          max_preds: int, seed: int = 0):
    """Synthetic data batch for benchmarking / tests (the JAX package's
    draws, so both packages get the same batch from one seed)."""
    rng = np.random.RandomState(seed)
    b, s, mp = batch_size, seq_len, max_preds
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    mask_pos = (np.tile(rng.permutation(s)[:mp], (b, 1))
                + (np.arange(b) * s)[:, None]).astype(np.int32)
    return {
        "input_ids": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
        "token_type_ids": (rng.rand(b, s) > 0.5).astype(np.int32),
        "position_ids": pos,
        "input_mask": np.ones((b, s), np.float32),
        "mask_positions": mask_pos.reshape(-1),
        "mask_labels": rng.randint(0, cfg.vocab_size,
                                   (b * mp, 1)).astype(np.int32),
        "mask_weights": np.ones((b * mp, 1), np.float32),
        "nsp_labels": rng.randint(0, 2, (b, 1)).astype(np.int32),
    }
