"""Device contexts of the PyTorch port (counterpart of ``mxnet_tpu/context.py``).

A context is a plain ``torch.device``. ``gpu(i)`` is CUDA device ``i``;
``default_device()`` is where the port's entry points run when the caller
names no device: the first CUDA device, or an error when there is none.
The port never carries on quietly on the CPU — a caller that wants the CPU
says ``device="cpu"``.
"""
from __future__ import annotations

import torch

from .base import MXNetError


def cpu(device_id=0):
    """The host (``device_id`` is accepted for reference parity)."""
    return torch.device("cpu")


def gpu(device_id=0):
    return torch.device("cuda", device_id)


def default_device():
    """``cuda:0``, or :class:`MXNetError` when no CUDA device is visible."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is visible; pass device='cpu' to run on the host")
    return gpu(0)


def resolve_device(device=None):
    """``device`` as a ``torch.device`` with its index; ``None`` means
    :func:`default_device`."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = gpu(torch.cuda.current_device())
    return device
