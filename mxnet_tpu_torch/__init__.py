"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` stays the reference; this package imports
``torch`` and nothing of JAX or of ``mxnet_tpu``. Ported so far: the
KV-cached transformer LM served through ``serving.GenerationEngine``,
whose prefill attention runs the hand-written CUDA flash-attention
forward (``csrc/flash_attn_fwd.cu``, built with ``nvcc`` at first use —
never at import).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit device they raise.
"""
from __future__ import annotations

from . import context, telemetry  # noqa: F401
from .base import MXNetError, __version__  # noqa: F401
from .context import cpu, default_device, gpu  # noqa: F401
