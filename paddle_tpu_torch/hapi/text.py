"""hapi.text — the NLP building blocks for hapi networks: the text-CNN
encoder and the transformer blocks.

Parity surface: reference python/paddle/incubate/hapi/text/text.py
(Conv1dPoolLayer:1980, CNNEncoder:2109, PrePostProcessLayer:2609,
MultiHeadAttention:2687, FFN:2900, TransformerEncoder:3061,
TransformerDecoder:3314); ported from the JAX package's ``hapi/text.py``
with the same parameter names.  Each block is a static-graph builder
whose ``__call__`` emits ops into the current Program:
``Conv1dPoolLayer`` a conv2d over the [B, 1, T, D] view and a max-pool
over time (global, or ``pool_size`` windows through ``squeeze`` and
``transpose``), ``CNNEncoder`` several of them joined by ``concat``;
``MultiHeadAttention`` the q/k/v/out projections around the fused
attention op (``ops/attention.py``); ``TransformerEncoder`` and
``TransformerDecoder`` one ``fused_encoder_stack`` /
``fused_decoder_stack`` op over all layers (``ops/encoder_stack.py``).

Not ported yet: the RNN cells and runners (``BasicLSTMCell``,
``BasicGRUCell``, ``RNN``, the stacked and bidirectional forms, the
seq2seq encoder and decoder), ``TransformerCell``, beam search and
``DynamicDecode``, which wait on the control-flow ops (ROADMAP A10, then
A9), and the CRF (``LinearChainCRF``, ``CRFDecoding``,
``SequenceTagging``, ROADMAP A9).

Instances are reusable and isolated: every block namespaces its
parameters under a unique (or user-given) prefix.
"""
from __future__ import annotations

from ..fluid import layers, unique_name
from ..fluid.initializer import ConstantInitializer, NormalInitializer
from ..fluid.layer_helper import LayerHelper
from ..fluid.param_attr import ParamAttr

__all__ = ["Conv1dPoolLayer", "CNNEncoder", "PrePostProcessLayer",
           "MultiHeadAttention", "FFN", "TransformerEncoder",
           "TransformerDecoder"]


class Conv1dPoolLayer:
    """Reference Conv1dPoolLayer (text.py:1980): a 1-D conv over the time
    axis of [B, T, D] and a max-pool over time.  Emitted as a conv2d with
    a [filter_size x D] kernel on the [B, 1, T, D] view."""

    def __init__(self, num_channels, num_filters, filter_size,
                 pool_size=None, act="tanh", name=None):
        self.num_channels = num_channels  # feature dim D
        self.num_filters = num_filters
        self.filter_size = int(filter_size)
        self.pool_size = pool_size  # None: global max pool over time
        self.act = act
        self.name = name or unique_name.generate("conv1d_pool")

    def __call__(self, x):
        b, t, d = x.shape
        x4 = layers.reshape(x, [b, 1, t, d])
        conv = layers.conv2d(
            x4, num_filters=self.num_filters,
            filter_size=[self.filter_size, d],
            padding=[self.filter_size // 2, 0], act=self.act,
            param_attr=ParamAttr(name=f"{self.name}.w_0"),
            bias_attr=ParamAttr(name=f"{self.name}.b_0"))
        # conv: [B, F, T', 1], pooled over T'
        if self.pool_size is None:
            return layers.reduce_max(conv, dim=[2, 3])  # [B, F]
        pooled = layers.pool2d(conv, pool_size=[self.pool_size, 1],
                               pool_type="max",
                               pool_stride=[self.pool_size, 1])
        pooled = layers.squeeze(pooled, axes=[3])  # [B, F, T'']
        return layers.transpose(pooled, [0, 2, 1])


class CNNEncoder:
    """Reference CNNEncoder (text.py:2109): parallel Conv1dPoolLayers
    with different filter sizes, their outputs concatenated."""

    def __init__(self, num_channels, num_filters, filter_sizes=(3, 4, 5),
                 pool_size=None, act="tanh", name=None):
        name = name or unique_name.generate("cnn_encoder")
        sizes = list(filter_sizes)
        filters = (num_filters if isinstance(num_filters, (list, tuple))
                   else [num_filters] * len(sizes))
        self.convs = [
            Conv1dPoolLayer(num_channels, f, s, pool_size=pool_size,
                            act=act, name=f"{name}.conv{i}")
            for i, (f, s) in enumerate(zip(filters, sizes))]

    def __call__(self, x):
        outs = [conv(x) for conv in self.convs]
        return layers.concat(outs, axis=-1) if len(outs) > 1 else outs[0]


class PrePostProcessLayer:
    """process_cmd string: 'a' residual add, 'n' layer_norm,
    'd' dropout, applied in order (reference text.py:2609)."""

    def __init__(self, process_cmd, d_model=None, dropout_rate=0.0,
                 name=None):
        self.cmd = process_cmd
        self.dropout_rate = float(dropout_rate)
        self.name = name or unique_name.generate("prepost")

    def __call__(self, prev_out, out=None, is_test=False):
        x = out if out is not None else prev_out
        for c in self.cmd:
            if c == "a" and prev_out is not None and out is not None:
                x = layers.elementwise_add(prev_out, x)
            elif c == "n":
                x = layers.layer_norm(
                    x, begin_norm_axis=len(x.shape) - 1,
                    param_attr=ParamAttr(name=f"{self.name}.ln_s"),
                    bias_attr=ParamAttr(name=f"{self.name}.ln_b"))
            elif c == "d" and self.dropout_rate and not is_test:
                x = layers.dropout(
                    x, self.dropout_rate,
                    dropout_implementation="upscale_in_train")
        return x


class MultiHeadAttention:
    """q/k/v projections, the fused attention op and the output
    projection (reference text.py:2687).  ``d_key``/``d_value`` are
    accepted for signature parity and unused: the fused op reads
    head-interleaved [B, S, d_model] with head dim d_model // n_head."""

    def __init__(self, d_key=None, d_value=None, d_model=512, n_head=1,
                 dropout_rate=0.0, name=None):
        self.d_model = int(d_model)
        self.n_head = int(n_head)
        self.dropout_rate = float(dropout_rate)
        self.name = name or unique_name.generate("mha")

    def _fc(self, x, suffix):
        return layers.fc(
            x, self.d_model, num_flatten_dims=2,
            param_attr=ParamAttr(name=f"{self.name}.{suffix}.w"),
            bias_attr=ParamAttr(name=f"{self.name}.{suffix}.b"))

    def __call__(self, queries, keys=None, values=None, attn_bias=None,
                 causal=False, is_test=False):
        keys = queries if keys is None else keys
        values = keys if values is None else values
        q = self._fc(queries, "q")
        k = self._fc(keys, "k")
        v = self._fc(values, "v")
        ctx = layers.fused_multihead_attention(
            q, k, v, attn_bias, num_heads=self.n_head,
            dropout_prob=self.dropout_rate, is_test=is_test,
            causal=causal)
        return self._fc(ctx, "out")


class FFN:
    """Position-wise feed-forward (reference text.py:2900)."""

    def __init__(self, d_inner_hid, d_model, dropout_rate=0.0,
                 fc1_act="relu", name=None):
        self.d_inner = int(d_inner_hid)
        self.d_model = int(d_model)
        self.dropout_rate = float(dropout_rate)
        self.act = fc1_act
        self.name = name or unique_name.generate("ffn")

    def __call__(self, x, is_test=False):
        inter = layers.fc(
            x, self.d_inner, num_flatten_dims=2, act=self.act,
            param_attr=ParamAttr(name=f"{self.name}.fc1.w"),
            bias_attr=ParamAttr(name=f"{self.name}.fc1.b"))
        if self.dropout_rate and not is_test:
            inter = layers.dropout(
                inter, self.dropout_rate,
                dropout_implementation="upscale_in_train")
        return layers.fc(
            inter, self.d_model, num_flatten_dims=2,
            param_attr=ParamAttr(name=f"{self.name}.fc2.w"),
            bias_attr=ParamAttr(name=f"{self.name}.fc2.b"))


def _stack_param(helper, name, shape, init=None):
    return helper.create_parameter(
        ParamAttr(name=name,
                  initializer=init or NormalInitializer(0.0, 0.02)),
        shape=shape, dtype="float32")


class _Stack:
    """The hyper-parameters both stacks share, and their one op."""

    def __init__(self, n_layer, n_head, d_key=None, d_value=None,
                 d_model=512, d_inner_hid=2048, prepostprocess_dropout=0.1,
                 attention_dropout=0.1, relu_dropout=0.1,
                 ffn_fc1_act="relu", name=None):
        self.n_layer = int(n_layer)
        self.n_head = int(n_head)
        self.d_model = int(d_model)
        self.d_inner = int(d_inner_hid)
        self.dropout = float(prepostprocess_dropout)
        self.attn_dropout = float(attention_dropout)
        self.act = ffn_fc1_act
        self.name = name or unique_name.generate(self._prefix)

    def _append(self, helper, ins, is_test):
        from ..fluid.layers.nn import _rng_salt_counter

        out = helper.create_variable_for_type_inference("float32")
        _rng_salt_counter[0] += 1
        helper.append_op(
            type=self._op, inputs=ins, outputs={"Out": [out]},
            attrs={"num_heads": self.n_head, "act": self.act,
                   "dropout_prob": self.dropout,
                   "attn_dropout_prob": self.attn_dropout,
                   "is_test": is_test, "use_flash_attention": True,
                   "rng_salt": _rng_salt_counter[0]})
        return out

    def _params(self, helper, specs):
        """{slot: stacked [L, ...] parameter} from (slot, suffix, shape,
        init) rows; init None is N(0, 0.02)."""
        return {slot: _stack_param(helper, f"{self.name}.{suffix}",
                                   [self.n_layer] + shape, init)
                for slot, suffix, shape, init in specs}


class TransformerEncoder(_Stack):
    """Reference TransformerEncoder (text.py:3061) on the fused stack op
    (ops/encoder_stack.py): flash attention, post-layernorm residual
    blocks, one op for all n_layer layers."""

    _prefix, _op = "transformer_encoder", "fused_encoder_stack"

    def __call__(self, enc_input, attn_bias=None, is_test=False):
        """enc_input: [B, S, d_model]; attn_bias: additive mask
        broadcastable to [B, n_head, S, S] (a [B, 1, 1, S] pad bias, or
        the reference recipe's full [B, n_head, S, S] one)."""
        h, f = self.d_model, self.d_inner
        ones, zeros = ConstantInitializer(1.0), ConstantInitializer(0.0)
        helper = LayerHelper(self._op)
        p = self._params(helper, [
            ("QKVW", "qkv_w", [h, 3 * h], None),
            ("QKVB", "qkv_b", [3 * h], zeros),
            ("OutW", "out_w", [h, h], None),
            ("OutB", "out_b", [h], zeros),
            ("Ln1S", "ln1_s", [h], ones),
            ("Ln1B", "ln1_b", [h], zeros),
            ("FfnW1", "ffn_w1", [h, f], None),
            ("FfnB1", "ffn_b1", [f], zeros),
            ("FfnW2", "ffn_w2", [f, h], None),
            ("FfnB2", "ffn_b2", [h], zeros),
            ("Ln2S", "ln2_s", [h], ones),
            ("Ln2B", "ln2_b", [h], zeros)])
        ins = {"Hidden": [enc_input], **{k: [v] for k, v in p.items()}}
        if attn_bias is not None:
            ins["AttnBias"] = [attn_bias]
        return self._append(helper, ins, is_test)


class TransformerDecoder(_Stack):
    """Reference TransformerDecoder (text.py:3314) on the fused decoder
    stack op (ops/encoder_stack.py): causal self-attention and
    rectangular cross-attention over the encoder output."""

    _prefix, _op = "transformer_decoder", "fused_decoder_stack"

    def __call__(self, dec_input, enc_output, cross_attn_bias=None,
                 is_test=False):
        """dec_input: [B, T, d_model]; enc_output: [B, S, d_model];
        cross_attn_bias: the source pad bias [B, 1, 1, S]."""
        h, f = self.d_model, self.d_inner
        ones, zeros = ConstantInitializer(1.0), ConstantInitializer(0.0)
        helper = LayerHelper(self._op)
        p = self._params(helper, [
            ("SelfQKVW", "self_qkv_w", [h, 3 * h], None),
            ("SelfQKVB", "self_qkv_b", [3 * h], zeros),
            ("SelfOutW", "self_out_w", [h, h], None),
            ("SelfOutB", "self_out_b", [h], zeros),
            ("Ln1S", "ln1_s", [h], ones),
            ("Ln1B", "ln1_b", [h], zeros),
            ("CrossQW", "cross_q_w", [h, h], None),
            ("CrossQB", "cross_q_b", [h], zeros),
            ("CrossKW", "cross_k_w", [h, h], None),
            ("CrossKB", "cross_k_b", [h], zeros),
            ("CrossVW", "cross_v_w", [h, h], None),
            ("CrossVB", "cross_v_b", [h], zeros),
            ("CrossOutW", "cross_out_w", [h, h], None),
            ("CrossOutB", "cross_out_b", [h], zeros),
            ("Ln2S", "ln2_s", [h], ones),
            ("Ln2B", "ln2_b", [h], zeros),
            ("FfnW1", "ffn_w1", [h, f], None),
            ("FfnB1", "ffn_b1", [f], zeros),
            ("FfnW2", "ffn_w2", [f, h], None),
            ("FfnB2", "ffn_b2", [h], zeros),
            ("Ln3S", "ln3_s", [h], ones),
            ("Ln3B", "ln3_b", [h], zeros)])
        ins = {"Hidden": [dec_input], "EncOut": [enc_output],
               **{k: [v] for k, v in p.items()}}
        if cross_attn_bias is not None:
            ins["SrcBias"] = [cross_attn_bias]
        return self._append(helper, ins, is_test)
