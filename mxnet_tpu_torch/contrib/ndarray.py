"""``mx.contrib.nd``: the registered contrib operators as NDArray
functions (counterpart of ``mxnet_tpu/contrib/ndarray.py``)."""
import sys as _sys

from . import ops as _ops  # noqa: F401  (registers the contrib operators)
from .ops import CONTRIB_OP_EXPORTS
from ..ndarray import _init_ndarray_module as _reinit
from ..ndarray import imperative_invoke
from ..ops import registry as _registry

_mod = _sys.modules[__name__]


def _make(opdef):
    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        return imperative_invoke(opdef, list(args), kwargs, out=out)

    fn.__name__ = opdef.name
    return fn


for _name in CONTRIB_OP_EXPORTS:
    if _registry.exists(_name):
        setattr(_mod, _name, _make(_registry.get(_name)))
_reinit()  # mx.nd gains the contrib operators too
