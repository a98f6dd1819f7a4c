"""``mx.contrib.symbol``: the registered contrib operators as Symbol
functions (counterpart of ``mxnet_tpu/contrib/symbol.py``)."""
import sys as _sys

from . import ops as _ops  # noqa: F401  (registers the contrib operators)
from .ops import CONTRIB_OP_EXPORTS
from ..ops import registry as _registry
from ..symbol import _init_symbol_module as _reinit
from ..symbol import _make_symbol_function

_mod = _sys.modules[__name__]
for _name in CONTRIB_OP_EXPORTS:
    if _registry.exists(_name):
        setattr(_mod, _name, _make_symbol_function(_registry.get(_name)))
_reinit()
