"""BERT/ERNIE-base encoder + pretraining heads.

Ported from the JAX package's ``models/bert.py``: the same functions
emit the same Program (op types, attrs, parameter names) through the port's
``fluid.layers``.  The attention core is the ``fused_multihead_attention``
op (flash-attention kernel on the card) when
``config.use_flash_attention`` is set; every post-LN ``layer_norm`` runs
the add+LN kernel.  ``fuse_stack=True`` builds the whole encoder as one
``fused_encoder_stack`` op over stacked ``encoder_stack.*`` parameters
(the same names as the JAX package's), as its bench trains BERT.
``moe_num_experts > 0`` replaces every dense FFN of the unfused encoder
with a ``moe_ffn`` of that many experts (``ops/moe_ops.py``) and adds
their load-balancing losses, scaled by ``moe_aux_weight``, to the
pretraining loss.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from .. import parallel
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
    # recompute the FFN inter activation / the q/k/v projections / the
    # whole layer in the backward (fuse_stack only)
    remat_ffn: bool = False
    remat_qkv: bool = False
    remat_layer: bool = False
    # checkpoint-name policy (fuse_stack only): comma-separated tags the
    # layer keeps ("flash" = the flash forward's o and lse), everything
    # else recomputed (ops/encoder_stack.py)
    remat_policy: str = ""
    # one fused_encoder_stack op over stacked layer params
    fuse_stack: bool = False
    # Mixture-of-Experts FFN (ops/moe_ops.py): > 0 replaces every dense
    # FFN with a moe_ffn of that many experts; shard them over "ep" with
    # DistributedStrategy.expert_parallel
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

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

    if cfg.moe_num_experts > 0:
        ffn_out, _aux = layers.moe_ffn(
            attn_out, num_experts=cfg.moe_num_experts,
            expert_hidden=cfg.intermediate_size, top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, act=cfg.hidden_act,
            param_attr=ParamAttr(initializer=_winit(cfg).initializer),
            name=f"{name}_moe")
    else:
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
        if cfg.moe_num_experts > 0:
            raise ValueError(
                "fuse_stack + moe_num_experts: the scanned stack cannot hold "
                "per-layer MoE routers yet; set fuse_stack=False for MoE")
        return _encoder_stack(cfg, emb, attn_bias, is_test)
    hidden = emb
    for i in range(cfg.num_hidden_layers):
        hidden = encoder_layer(cfg, hidden, attn_bias, f"encoder_layer_{i}",
                               is_test)
    return hidden


def _encoder_stack(cfg: BertConfig, hidden, attn_bias, is_test: bool):
    """One fused_encoder_stack op (ops/encoder_stack.py) over stacked
    [L, ...] params named encoder_stack.*."""
    from ..fluid.layer_helper import LayerHelper
    from ..fluid.layers.nn import _rng_salt_counter

    L, h, f = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    helper = LayerHelper("fused_encoder_stack")

    def param(name, shape, init=None):
        return helper.create_parameter(
            ParamAttr(name=f"encoder_stack.{name}",
                      initializer=init or TruncatedNormalInitializer(
                          scale=cfg.initializer_range)),
            shape=shape, dtype="float32")

    ones = ConstantInitializer(1.0)
    zeros = ConstantInitializer(0.0)
    p = {
        "QKVW": param("qkv_w", [L, h, 3 * h]),
        "QKVB": param("qkv_b", [L, 3 * h], zeros),
        "OutW": param("out_w", [L, h, h]),
        "OutB": param("out_b", [L, h], zeros),
        "Ln1S": param("ln1_scale", [L, h], ones),
        "Ln1B": param("ln1_bias", [L, h], zeros),
        "FfnW1": param("ffn_w1", [L, h, f]),
        "FfnB1": param("ffn_b1", [L, f], zeros),
        "FfnW2": param("ffn_w2", [L, f, h]),
        "FfnB2": param("ffn_b2", [L, h], zeros),
        "Ln2S": param("ln2_scale", [L, h], ones),
        "Ln2B": param("ln2_bias", [L, h], zeros),
    }
    out = helper.create_variable_for_type_inference("float32")
    _rng_salt_counter[0] += 1
    helper.append_op(
        type="fused_encoder_stack",
        inputs={"Hidden": [hidden], "AttnBias": [attn_bias],
                **{k: [v] for k, v in p.items()}},
        outputs={"Out": [out]},
        attrs={
            "num_heads": cfg.num_attention_heads,
            "act": cfg.hidden_act,
            "dropout_prob": cfg.hidden_dropout_prob,
            "attn_dropout_prob": cfg.attention_probs_dropout_prob,
            "is_test": is_test,
            "use_flash_attention": cfg.use_flash_attention,
            "remat_ffn": cfg.remat_ffn,
            "remat_qkv": cfg.remat_qkv,
            "remat_layer": cfg.remat_layer,
            "remat_policy": cfg.remat_policy,
            "rng_salt": _rng_salt_counter[0],
        },
    )
    return out


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
        # flat indices into [B * S]: a data-parallel rank re-bases its block
        parallel.set_flat_index(mask_positions, batch_size, seq_len)
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

        # ---- the MoE load-balancing losses (one a moe_ffn op) ----
        block = main.global_block()
        aux_names = [n for op in block.ops if op.type == "moe_ffn"
                     for n in op.outputs.get("AuxLoss", [])]
        if aux_names:
            aux_total = block.var(aux_names[0])
            for n in aux_names[1:]:
                aux_total = layers.elementwise_add(aux_total, block.var(n))
            loss = layers.elementwise_add(
                loss, layers.scale(aux_total, scale=cfg.moe_aux_weight))

    feed_names = ["input_ids", "token_type_ids", "position_ids", "input_mask",
                  "mask_positions", "mask_labels", "mask_weights",
                  "nsp_labels"]
    return main, startup, feed_names, loss


def tensor_parallel_rules():
    """Megatron's PartitionSpec rules for the unfused encoder (the JAX
    package's): QKV and FFN-in column-parallel (their output dim and bias
    on "tp"), the attention-output and FFN-out projections row-parallel,
    and the word embedding sharded by vocabulary (which the tied MLM
    head reads too).  ``fleet.apply_tensor_parallel_rules`` turns them
    into the ops' regions."""
    col_w = (None, "tp")
    row_w = ("tp", None)
    return [
        (r"_(query|key|value)_fc\.w_0$", col_w),
        (r"_(query|key|value)_fc\.b_0$", ("tp",)),
        (r"_output_fc\.w_0$", row_w),
        (r"_ffn_fc_0\.w_0$", col_w),
        (r"_ffn_fc_0\.b_0$", ("tp",)),
        (r"_ffn_fc_1\.w_0$", row_w),
        (r"^word_embedding$", row_w),  # vocab-sharded
    ]


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
