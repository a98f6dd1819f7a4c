"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` stays the reference; this package imports
``torch`` and nothing of JAX or of ``mxnet_tpu``. Ported so far: the
KV-cached transformer LM served through ``serving.GenerationEngine``, and
its training (``examples.train_transformer_lm``). Attention runs the
hand-written CUDA flash-attention forward (``csrc/flash_attn_fwd.cu``) and
its gradient the dq and dk/dv kernels (``csrc/flash_attn_bwd.cu``), built
with ``nvcc`` at first use — never at import.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit device they raise.
"""
from __future__ import annotations

from . import context, telemetry  # noqa: F401
from .base import MXNetError, __version__  # noqa: F401
from .context import cpu, default_device, gpu  # noqa: F401
