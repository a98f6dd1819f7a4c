"""Device contexts of the PyTorch port (counterpart of ``mxnet_tpu/context.py``).

A :class:`Context` is MXNet's (device_type, device_id) pair, with the
thread-local default-context stack of ``with ctx:``. It resolves to a
``torch.device``: ``gpu(i)`` is CUDA device ``i``, ``cpu()`` the host.

Where the JAX package quietly turns ``gpu`` into the host when no
accelerator is present (``mxnet_tpu/context.py:64-69``), the port raises
:class:`MXNetError`. With no context entered, :func:`current_context` is
``gpu(0)``, so the port's entry points run on the card unless the caller
enters ``with mx.cpu():`` or passes a device; without a card they raise.
``resolve_device`` takes a ``torch.device``, a string or a ``Context``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

_DEVTYPE2ID = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}
_DEVID2TYPE = {v: k for k, v in _DEVTYPE2ID.items()}


class Context:
    """A device context (device_type, device_id) that resolves to a
    ``torch.device``."""

    _default_ctx = threading.local()
    devtype2id = _DEVTYPE2ID
    devid2type = _DEVID2TYPE

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_type = device_type.device_type
            self.device_id = device_type.device_id
            return
        if isinstance(device_type, torch.device):
            device_id = device_type.index or 0
            device_type = "gpu" if device_type.type == "cuda" else device_type.type
        elif device_type == "cuda":
            device_type = "gpu"
        if device_type not in _DEVTYPE2ID:
            raise MXNetError("unknown device type %s" % device_type)
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device_typeid(self):
        return _DEVTYPE2ID[self.device_type]

    @property
    def torch_device(self):
        """The ``torch.device``; raises :class:`MXNetError` for a ``gpu``
        context when no such CUDA device is visible."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if self.device_id >= count:
            raise MXNetError(
                "context %s: no such CUDA device (%d visible); enter `with mx.cpu():` "
                "or pass device='cpu' to run on the host" % (self, count))
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (
            isinstance(other, Context)
            and self.device_type == other.device_type
            and self.device_id == other.device_id
        )

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    def __enter__(self):
        if not hasattr(Context._default_ctx, "stack"):
            Context._default_ctx.stack = []
        Context._default_ctx.stack.append(getattr(Context._default_ctx, "value", None))
        Context._default_ctx.value = self
        return self

    def __exit__(self, *args):
        Context._default_ctx.value = Context._default_ctx.stack.pop()

    @staticmethod
    def current_context():
        """The innermost entered context, else ``gpu(0)``; raises
        :class:`MXNetError` when that is ``gpu(0)`` and no card is visible."""
        ctx = getattr(Context._default_ctx, "value", None)
        if ctx is not None:
            return ctx
        ctx = Context("gpu", 0)
        ctx.torch_device  # noqa: B018  (raises without a card)
        return ctx

    @staticmethod
    def default_ctx():  # reference-compat alias
        return Context.current_context()


def cpu(device_id=0):
    """The host (``device_id`` is kept for reference parity)."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """CUDA device ``device_id``."""
    return Context("gpu", device_id)


def current_context():
    return Context.current_context()


def num_devices(device_type="gpu"):
    """CUDA devices visible to this process (``gpu``), or 1 (``cpu``)."""
    if device_type in ("cpu", "cpu_pinned"):
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def as_context(ctx):
    """``ctx`` (a Context, torch.device or string; None: the current
    context) as a :class:`Context`."""
    if ctx is None:
        return current_context()
    if isinstance(ctx, Context):
        return ctx
    return Context(torch.device(ctx) if isinstance(ctx, str) else ctx)


def default_device():
    """The current context's ``torch.device``: ``cuda:0`` unless a context
    is entered; :class:`MXNetError` when that is a card and none is
    visible."""
    return current_context().torch_device


def resolve_device(device=None):
    """``device`` (a ``torch.device``, a string or a :class:`Context`) as a
    ``torch.device`` with its index; ``None`` means :func:`default_device`."""
    if device is None:
        return default_device()
    if isinstance(device, Context):
        return device.torch_device
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
