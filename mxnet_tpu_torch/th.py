"""The torch bridge of the port, ``mx.th`` (also ``mx.torch``; counterpart
of ``mxnet_tpu/torch.py``, the reference's torch plugin).

In the JAX package the bridge copies NDArrays to host torch tensors and
back. Here every NDArray already is a torch tensor, so the bridge is the
identity:

- ``mx.th.<fn>(...)`` applies ``torch.<fn>`` to the NDArrays' tensors (on
  their device) and returns NDArrays over the results; a result that
  shares storage with an argument is copied first.
- ``wrap_module(nn_module)`` registers the module as a ``Custom`` operator
  and returns a symbol factory. Its forward runs the module on the graph's
  tensor where it lies; its backward is ``torch.autograd.grad`` of that
  forward, for the operator's input and for the module's own parameters,
  whose gradients accumulate in their ``.grad`` (the module owns its
  weights, as the reference's TorchModule does; the MXNet optimizer does
  not see them). Nothing crosses to the host.

The file is named ``th.py``: a module named ``torch.py`` inside a package
whose every module does ``import torch`` is a trap for any script run with
the package directory on ``sys.path``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import operator
from . import symbol as sym_mod
from .base import MXNetError
from .context import current_context
from .ndarray import NDArray, _own


def _to_torch(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x)).to(current_context().torch_device)
    return x


def _from_torch(v, args):
    if isinstance(v, torch.Tensor):
        return NDArray(_own(v.detach(), args))
    return v


def __getattr__(name):
    """mx.th.<fn>: torch.<fn> on NDArrays."""
    fn = getattr(torch, name, None)
    if fn is None or not callable(fn) or name.startswith("_"):
        raise AttributeError("torch has no function %r" % name)

    def wrapper(*args, **kwargs):
        targs = [_to_torch(a) for a in args]
        tkwargs = {k: _to_torch(v) for k, v in kwargs.items()}
        ins = targs + list(tkwargs.values())
        out = fn(*targs, **tkwargs)
        if isinstance(out, (list, tuple)):
            return type(out)(_from_torch(v, ins) for v in out)
        return _from_torch(out, ins)

    wrapper.__name__ = name
    return wrapper


_WRAPPED = {}


def wrap_module(nn_module, name=None):
    """Register a torch ``nn.Module`` as a Custom operator and return a
    symbol factory ``f(data_sym, name=...) -> Symbol`` (see the module
    docstring). The module runs in its own dtype on the tensor's device:
    move it to the graph's device first."""
    op_name = name or ("torch_%s_%d" % (type(nn_module).__name__.lower(), len(_WRAPPED)))
    if op_name in _WRAPPED:
        raise MXNetError("torch module op %r already registered" % op_name)
    _WRAPPED[op_name] = nn_module

    @operator.register(op_name)
    class _TorchModuleProp(operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            was_training = nn_module.training
            nn_module.eval()  # the zero probe must not move BatchNorm's stats
            try:
                with torch.no_grad():
                    param = next(nn_module.parameters(), None)
                    dev = param.device if param is not None else None
                    out = nn_module(torch.zeros(*[int(d) for d in in_shape[0]], device=dev))
            finally:
                nn_module.train(was_training)
            return [in_shape[0]], [tuple(out.shape)], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class _TorchModuleOp(operator.CustomOp):
                def memo_key(self):
                    # the output depends on the module's weights too
                    return tuple((id(p), p._version) for p in nn_module.parameters())

                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0]._data
                    nn_module.train(bool(is_train))  # Dropout / BatchNorm follow is_train
                    if is_train:
                        x = x.detach().requires_grad_(True)
                        with torch.enable_grad():
                            y = nn_module(x)
                        self._saved = (x, y)
                    else:
                        with torch.no_grad():
                            y = nn_module(x)
                    self.assign(out_data[0], req[0], NDArray(y.detach()))

                def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
                    x, y = self._saved
                    params = [p for p in nn_module.parameters() if p.requires_grad]
                    grads = torch.autograd.grad(y, [x] + params, grad_outputs=out_grad[0]._data,
                                                allow_unused=True)
                    gx = grads[0] if grads[0] is not None else torch.zeros_like(x)
                    self.assign(in_grad[0], req[0], NDArray(gx))
                    with torch.no_grad():
                        for p, g in zip(params, grads[1:]):
                            if g is not None:
                                if p.grad is None:
                                    p.grad = g.clone()
                                else:
                                    p.grad += g

            return _TorchModuleOp()

    def build(data_sym, name=None, **kwargs):
        return sym_mod.Custom(data_sym, op_type=op_name, name=name or op_name, **kwargs)

    build.op_name = op_name
    return build
