"""Fault tolerance of the PyTorch port (counterpart of
``mxnet_tpu/resilience``), for training on preemptible cards.

* :mod:`.checkpoint` — atomic full-state checkpoints (temp + fsync +
  rename, CRC32 manifest, keep-last-N) and valid-checkpoint discovery, in
  the JAX package's on-disk layout, so a checkpoint either package writes
  verifies and loads in the other.
* Preemption — ``Module.fit`` installs SIGTERM/SIGINT handlers when
  checkpointing is on, finishes the step group in flight, writes a final
  checkpoint and exits :data:`EXIT_PREEMPTED`.
* Resume — ``fit(..., checkpoint_dir=..., resume="auto")`` restores
  params, optimizer state, RNG streams, metric accumulation and the data
  iterator's position from the newest checkpoint that verifies, bit for
  bit within the package.
* :mod:`.retry` — jittered exponential backoff with transient-error
  classification, shared by the kvstore and checkpoint I/O.
* :mod:`.guardrail` — the numeric guardrails: the skip gate in the fused
  step, rewind to the last good checkpoint (``fit(guardrails="auto")``),
  and the :data:`EXIT_GUARDRAIL` verdict when the rewind budget runs out.

:mod:`.fault` is the test-only injection switchboard
(``MXTPU_FAULT_INJECT``). The elastic shrink (``MXTPU_ELASTIC``) lives in
``fit`` (``module/base_module.py``) and ``tools/watchdog.py``.
"""
from . import checkpoint, fault, guardrail, retry  # noqa: F401
from .checkpoint import (  # noqa: F401
    EXIT_PREEMPTED, EXIT_RESHAPE, CheckpointError, CheckpointManager,
    atomic_file, list_checkpoints, load_state, verify_checkpoint,
)
from .guardrail import (  # noqa: F401
    EXIT_GUARDRAIL, GuardrailMonitor, GuardrailRewind,
)
from .retry import TransientError, is_retryable  # noqa: F401
