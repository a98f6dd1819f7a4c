"""RNN checkpoint helpers of the PyTorch port (counterpart of
``mxnet_tpu/rnn/rnn.py``): a fused cell's blob is unpacked into per-gate
arrays before saving and packed again on loading, over the port's
``model.save_checkpoint`` / ``load_checkpoint``, so the files are the JAX
package's and load in either package."""
from __future__ import annotations

from ..model import load_checkpoint, save_checkpoint


def rnn_unroll(cell, length, inputs=None, begin_state=None, input_prefix="", layout="NTC"):
    """Deprecated alias of ``cell.unroll``."""
    return cell.unroll(length, inputs=inputs, begin_state=begin_state,
                       input_prefix=input_prefix, layout=layout)


def _cells(cells):
    return list(cells) if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """``model.save_checkpoint`` with every cell's weights unpacked."""
    for cell in _cells(cells):
        arg_params = cell.unpack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """(symbol, arg_params, aux_params) with every cell's weights packed."""
    sym, arg, aux = load_checkpoint(prefix, epoch)
    for cell in _cells(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback saving an RNN checkpoint every ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
