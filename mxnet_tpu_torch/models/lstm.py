"""LSTM language models of the PyTorch port (counterpart of
``mxnet_tpu/models/lstm.py``): the PTB bucketing workload of the
reference's ``example/rnn/lstm_bucketing.py`` / ``cudnn_lstm_bucketing.py``.

- ``lstm_unroll``: the unrolled ``LSTMCell`` stack (the per-step graph);
- ``fused_lstm_sym``: ``FusedRNNCell``, the fused ``RNN`` operator (cuDNN
  on the card);
- ``BucketingLSTMModel``: the ``sym_gen`` of ``BucketingModule`` over
  either;
- ``lstm_attention_lm``: a symbol-free LSTM LM whose readout attends
  causally over the hidden sequence through ``ops.kernels.attention``, so
  on the card its forward launches the flash kernel K4f and its backward
  (through ``torch.autograd``) K4dq and K4dkv.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import symbol as sym
from ..ops import kernels
from ..ops.rnn_op import rnn_weights
from ..rnn.rnn_cell import FusedRNNCell, LSTMCell, SequentialRNNCell


def lstm_unroll(num_layers, seq_len, input_size, num_hidden, num_embed, num_label,
                dropout=0.0):
    """Unrolled symbol for one bucket length (sym_gen inner)."""
    stack = SequentialRNNCell()
    for i in range(num_layers):
        stack.add(LSTMCell(num_hidden=num_hidden, prefix="lstm_l%d_" % i))
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    embed = sym.Embedding(data, input_dim=input_size, output_dim=num_embed, name="embed")
    stack.reset()
    outputs, states = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
    pred = sym.Reshape(outputs, shape=(-1, num_hidden))
    pred = sym.FullyConnected(pred, num_hidden=num_label, name="pred")
    label_flat = sym.Reshape(label, shape=(-1,))
    return sym.SoftmaxOutput(pred, label_flat, name="softmax")


def fused_lstm_sym(num_layers, seq_len, input_size, num_hidden, num_embed, num_label,
                   dropout=0.0):
    """The FusedRNNCell path (the reference's cudnn_lstm_bucketing.py);
    returns (symbol, cell)."""
    cell = FusedRNNCell(num_hidden, num_layers=num_layers, mode="lstm", dropout=dropout)
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    embed = sym.Embedding(data, input_dim=input_size, output_dim=num_embed, name="embed")
    outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True, layout="NTC")
    pred = sym.Reshape(outputs, shape=(-1, num_hidden))
    pred = sym.FullyConnected(pred, num_hidden=num_label, name="pred")
    label_flat = sym.Reshape(label, shape=(-1,))
    return sym.SoftmaxOutput(pred, label_flat, name="softmax"), cell


def lstm_attention_lm(vocab=10000, num_hidden=256, num_embed=256, n_heads=4, dtype=None):
    """LSTM LM with an attention readout.

    Returns (init_fn(seed) -> name -> f32 numpy array, the JAX package's
    draws; apply_fn(params, tokens, mesh=None) -> f32 logits [B, T, vocab]),
    ``params`` torch tensors (``models.common.params_from_numpy``) and
    ``tokens`` an integer tensor [B, T]. One LSTM layer (gate order i, f,
    g, o) runs through ``torch._VF.lstm`` (cuDNN on the card); each
    position then attends causally over the whole hidden sequence, and the
    logits read hs + attention. A mesh whose 'sp' axis is > 1 raises, as
    the attention dispatcher does."""
    dtype = dtype or torch.float32
    assert num_hidden % n_heads == 0
    head_dim = num_hidden // n_heads

    def init_fn(seed=0):
        rng = np.random.RandomState(seed)

        def w(*shape, scale=None):
            scale = scale or (1.0 / np.sqrt(shape[0]))
            return (rng.randn(*shape) * scale).astype(np.float32)

        return {
            "embed": w(vocab, num_embed, scale=0.02),
            "wx": w(num_embed, 4 * num_hidden),
            "wh": w(num_hidden, 4 * num_hidden),
            "b": np.zeros((4 * num_hidden,), np.float32),
            "wq": w(num_hidden, num_hidden),
            "wk": w(num_hidden, num_hidden),
            "wv": w(num_hidden, num_hidden),
            "wo": w(num_hidden, num_hidden),
            "pred": w(num_hidden, vocab),
        }

    def apply_fn(params, tokens, mesh=None):
        B, T = tokens.shape
        x = params["embed"][tokens.long()].to(dtype)  # [B, T, E]
        b = params["b"].to(dtype)
        # torch's layout: w_ih [4H, E], w_hh [4H, H], the bias once (b_hh = 0)
        weights = rnn_weights([params["wx"].to(dtype).T, params["wh"].to(dtype).T, b,
                               torch.zeros_like(b)], "lstm", num_embed, num_hidden, 1, False)
        h0 = torch.zeros((1, B, num_hidden), dtype=dtype, device=x.device)
        train = torch.is_grad_enabled() and any(p.requires_grad for p in params.values())
        hs, _, _ = torch._VF.lstm(x, (h0, h0), weights, True, 1, 0.0, train, False, True)
        q, k, v = ((hs @ params[n].to(dtype)).reshape(B, T, n_heads, head_dim)
                   for n in ("wq", "wk", "wv"))
        o = kernels.attention(q, k, v, causal=True, mesh=mesh)
        ctx = o.reshape(B, T, num_hidden) @ params["wo"].to(dtype)
        return (hs + ctx).float() @ params["pred"]

    return init_fn, apply_fn


class BucketingLSTMModel:
    """sym_gen factory for BucketingModule (the reference's
    lstm_bucketing.py:69)."""

    def __init__(self, num_layers, input_size, num_hidden, num_embed, num_label, dropout=0.0,
                 fused=False):
        self.num_layers = num_layers
        self.input_size = input_size
        self.num_hidden = num_hidden
        self.num_embed = num_embed
        self.num_label = num_label
        self.dropout = dropout
        self.fused = fused

    def __call__(self, bucket_key):
        builder = fused_lstm_sym if self.fused else lstm_unroll
        out = builder(self.num_layers, bucket_key, self.input_size, self.num_hidden,
                      self.num_embed, self.num_label, self.dropout)
        symf = out[0] if isinstance(out, tuple) else out
        return symf, ("data",), ("softmax_label",)
