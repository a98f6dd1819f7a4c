"""Contrib namespace (counterpart of ``mxnet_tpu/contrib``): the legacy
autograd names and the contrib operators ported so far, as Symbol and
NDArray functions."""
from . import autograd  # noqa: F401
from . import ndarray  # noqa: F401
from . import symbol  # noqa: F401
