"""Global random seed of the PyTorch port (counterpart of
``mxnet_tpu/random.py``).

One explicit ``torch.Generator`` per device, seeded by :func:`seed`; the
sampling operators draw from the generator of the device they run on.
Streams cannot match the JAX package's threefry keys, so samplers are held
to it by their moments, and a run is reproducible after ``seed()``.
``get_state`` / ``set_state`` snapshot and restore one device's stream, by
default the current context's: the one the samplers draw from.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

from .context import resolve_device

_state = threading.local()


def _st():
    if not hasattr(_state, "generators"):
        _state.generators = {}
        _state.seed = None
    return _state


def generator(device=None):
    """The generator of ``device`` (default: the current context's device,
    through :func:`~mxnet_tpu_torch.context.resolve_device`), made (and
    seeded from the last :func:`seed`, or from numpy's global stream) on
    first use."""
    st = _st()
    device = resolve_device(device)
    gen = st.generators.get(device)
    if gen is None:
        if st.seed is None:
            st.seed = int(_np.random.randint(0, 2**31 - 1))
        gen = torch.Generator(device=device)
        gen.manual_seed(st.seed)
        st.generators[device] = gen
    return gen


def seed(seed_state: int):
    """Seed every device's sampler stream (parity: mx.random.seed)."""
    st = _st()
    st.seed = int(seed_state)
    for gen in st.generators.values():
        gen.manual_seed(st.seed)


def get_state(device=None):
    """Snapshot ``device``'s stream (default: the current context's, which
    the samplers draw from; ``gpu(0)`` when no context is entered, raising
    :class:`MXNetError` without a card) as a host uint8 array."""
    return generator(device).get_state().numpy().copy()


def set_state(state, device=None):
    """Restore a stream captured by :func:`get_state` (default device as
    there)."""
    generator(device).set_state(torch.from_numpy(_np.asarray(state, _np.uint8)))


def fork(gen):
    """A new generator on ``gen``'s device in ``gen``'s current state, so a
    recorded draw can be replayed without moving ``gen``."""
    twin = torch.Generator(device=gen.device)
    twin.set_state(gen.get_state())
    return twin


# sampler front-ends (uniform/normal/...) are generated onto this module by
# mxnet_tpu_torch.ndarray at import; see _init_random_module there.
