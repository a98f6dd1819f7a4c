"""Imperative autograd of the PyTorch port (counterpart of
``mxnet_tpu/autograd.py``).

As in the JAX package, the imperative layer records a tape of
(operator, attrs, inputs, outputs) while training, and ``backward``
replays it as a function of the marked variables. The replay runs on
fresh leaf tensors that require grad, and ``torch.autograd.grad`` takes the
gradients. The NDArrays' own tensors never require grad, so a marked
variable still takes in-place writes (``x[:] = ...``) and no torch graph
outlives a step. A recorded sampling operator replays with a copy of the
generator state it drew from, so the replay draws the same numbers.
"""
from __future__ import annotations

import functools
import threading

import torch

from .base import MXNetError

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
        _state.tape = []  # list of (opdef, attrs, input NDArrays, output NDArrays)
        _state.marked = {}  # id(NDArray) -> (NDArray, grad NDArray)
        _state.grad_reqs = {}
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_is_training(train_mode):
    """Parity: MXAutogradSetIsTraining. Returns previous state."""
    st = _st()
    prev = st.training
    st.training = bool(train_mode)
    st.recording = bool(train_mode)
    return prev


class train_section:
    """``with autograd.train_section():`` — reference contrib/autograd.py."""

    def __enter__(self):
        self._prev = set_is_training(True)
        return self

    def __exit__(self, *args):
        set_is_training(self._prev)


class test_section:
    def __enter__(self):
        self._prev = set_is_training(False)

    def __exit__(self, *args):
        set_is_training(self._prev)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to variables (parity: MXAutogradMarkVariables);
    ``grad_reqs`` is write, add or null, one for all or one each."""
    st = _st()
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, grad, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("mark_variables: unknown grad_req %r" % (req,))
        st.marked[id(var)] = (var, grad)
        st.grad_reqs[id(var)] = req


def record_op(opdef, attrs, inputs, outputs):
    """Called by the imperative invoke path while recording."""
    st = _st()
    st.tape.append((opdef, dict(attrs), list(inputs), list(outputs)))


def _replay(tape, env, outputs):
    """Run ``tape`` with ``env`` (id(NDArray) -> tensor) standing in for the
    marked variables; returns the tensors of ``outputs``."""
    from .ndarray import NDArray
    from .random import fork

    def lookup(x):
        if not isinstance(x, NDArray):
            return x  # constant input recorded as a tensor
        return env.get(id(x), x._data)

    for opdef, attrs, ins, outs in tape:
        if "__rng__" in attrs:
            attrs = dict(attrs, __rng__=fork(attrs["__rng__"]))
        result = opdef.fcompute(attrs, [lookup(x) for x in ins], True)
        for o, v in zip(outs, result):
            env[id(o)] = v
    return [env.get(id(o), o._data) for o in outputs]


def backward(outputs, out_grads=None, retain_graph=False):
    """Replay the tape as a torch function of the marked variables and
    write gradients into their attached buffers by grad_req."""
    from .ndarray import NDArray

    st = _st()
    if not st.marked:
        raise MXNetError("autograd.backward: no variables marked")
    if isinstance(outputs, NDArray):
        outputs = [outputs]
    var_ids = list(st.marked.keys())
    leaves = [st.marked[i][0]._data.detach().clone().requires_grad_(
        st.marked[i][0]._data.is_floating_point()) for i in var_ids]
    with torch.enable_grad():
        outs = _replay(list(st.tape), dict(zip(var_ids, leaves)), outputs)
    if out_grads is None:
        cts = [torch.ones_like(o) for o in outs]
    else:
        cts = [g._data if isinstance(g, NDArray) else torch.as_tensor(g, device=o.device)
               for g, o in zip(out_grads, outs)]
    live = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
    diff = [x for x in leaves if x.requires_grad]
    grads = iter(torch.autograd.grad([o for o, _ in live], diff, [c for _, c in live],
                                     allow_unused=True) if live and diff else [None] * len(diff))
    with torch.no_grad():
        for i, leaf in zip(var_ids, leaves):
            g = next(grads) if leaf.requires_grad else None
            var, gbuf = st.marked[i]
            req = st.grad_reqs.get(i, "write")
            if req == "null":
                continue
            if g is None:
                g = torch.zeros_like(leaf)
            if req == "add":
                gbuf._data.add_(g.to(gbuf._data.dtype))
            else:
                gbuf._data.copy_(g)
    if not retain_graph:
        st.tape = []


def compute_gradient(outputs):
    """Deprecated reference API alias."""
    backward(outputs)


def grad_and_loss(func, argnum=None):
    """Decorator returning (gradients, loss) (parity contrib/autograd.py)."""

    @functools.wraps(func)
    def wrapped(*args):
        from . import ndarray as nd
        from .ndarray import NDArray

        variables = list(args)
        if argnum is not None:
            argnums = [argnum] if isinstance(argnum, int) else list(argnum)
            variables = [args[i] for i in argnums]
        for x in variables:
            if not isinstance(x, NDArray):
                raise MXNetError("variables must be NDArrays")
        grads = [nd.zeros_like(x) for x in variables]
        mark_variables(variables, grads)
        prev = set_is_training(True)
        try:
            outputs = func(*args)
        finally:
            set_is_training(prev)
        backward([outputs] if isinstance(outputs, NDArray) else outputs)
        return grads, outputs

    return wrapped


def grad(func, argnum=None):
    grad_with_loss_func = grad_and_loss(func, argnum)

    @functools.wraps(grad_with_loss_func)
    def wrapped(*args):
        return grad_with_loss_func(*args)[0]

    return wrapped
