"""Core shared definitions of the PyTorch port (counterpart of
``mxnet_tpu/base.py``): the framework's error type and version."""
from __future__ import annotations

__version__ = "0.9.5"


class MXNetError(RuntimeError):
    """Error raised by the framework (parity: reference ``base.py:MXNetError``)."""
