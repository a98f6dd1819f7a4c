"""RNN toolkit of the PyTorch port (counterpart of ``mxnet_tpu/rnn``): the
symbolic cells, ``BucketSentenceIter`` and the RNN checkpoint helpers."""
from .rnn_cell import (  # noqa: F401
    BaseRNNCell, RNNCell, LSTMCell, GRUCell, FusedRNNCell, SequentialRNNCell,
    BidirectionalCell, DropoutCell, ZoneoutCell, ResidualCell, ModifierCell,
    RNNParams,
)
from .io import BucketSentenceIter, encode_sentences  # noqa: F401
from .rnn import (  # noqa: F401
    save_rnn_checkpoint, load_rnn_checkpoint, do_rnn_checkpoint, rnn_unroll,
)
