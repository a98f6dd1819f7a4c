"""Serving-engine surface shared by the port's engines (counterpart of
``mxnet_tpu/serving/engine.py``). Only :class:`ServeClosed` is ported so
far; the continuous-batching ``ServingEngine`` over Symbol predictors
waits for the Symbol layer."""
from __future__ import annotations

from ..base import MXNetError


class ServeClosed(MXNetError):
    """Raised by submit() once the engine is draining or stopped."""
