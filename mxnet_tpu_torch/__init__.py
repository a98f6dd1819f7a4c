"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` stays the reference; this package imports
``torch`` and nothing of JAX or of ``mxnet_tpu``. Ported so far: the
KV-cached transformer LM served through ``serving.GenerationEngine``
(its decode step one captured CUDA graph on the card), and its training (``examples.train_transformer_lm``); the Symbol layer
(``symbol``, ``name``, ``attribute``, ``ops.registry``), ``models.resnet``
and ``tools.resnet_bench`` (bench.py's ResNet-50 step); the imperative API
(``nd``, ``random``, ``autograd``) over the operator modules
(``ops.elemwise``, ``broadcast_reduce``, ``matrix``, ``init_ops``,
``indexing``, ``sample``, ``optimizer_ops``, part of ``nn``); the bound
``Executor`` (``bind`` / ``simple_bind`` / forward / backward);
``rtc``, CUDA C kernels compiled at run time by NVRTC; and the training
stack: ``init``, ``optimizer``, ``lr_scheduler``, ``metric``, ``callback``,
``io``, ``kv``, ``model`` (with the deprecated ``FeedForward``) and
``mod.Module`` with its ``fit`` loop (and ``BucketingModule``,
``SequentialModule``, ``PythonModule`` / ``PythonLossModule`` and
``MutableModule`` over it; ``executor_manager``), whose
fused data-parallel path runs over a ``parallel.make_mesh`` of logical
ranks on one device (``parallel.ShardedTrainStep``); and the serving
surface: ``predict.Predictor`` (one captured CUDA graph a batch bucket on
the card), bundles, ``serving.ServingEngine``, int8 ``serving.quant`` and
``tools.serve``; and ``resilience``: atomic checkpoints, preemption and
crash resume, fault injection, retries and the guardrails of ``fit``; and
``rnn``: the symbolic RNN cells over the fused ``RNN`` operator (cuDNN on
the card), ``BucketSentenceIter`` and the RNN checkpoint helpers; and, on
meshes of logical ranks of one device, ``parallel``'s ring attention over
the 'sp' axis, the Switch-MoE FFN (also the ``contrib`` operator
``SwitchMoE``) and the GPipe pipeline over 'pp'; and the observability
layer: ``telemetry`` (metrics, spans, JSONL / Prometheus export, the step
anatomy with the H100 peak tables, the fleet view and ``/metrics``),
``profiler`` (``torch.profiler`` with kernel attribution), ``monitor`` and
``viz``.

Attention runs the hand-written CUDA flash-attention forward
(``csrc/flash_attn_fwd.cu``) and its gradient the dq and dk/dv kernels
(``csrc/flash_attn_bwd.cu``); convolution gradients inside the envelope
run the filter- and data-gradient kernels (``csrc/conv_bwd.cu``); the
bf16 AMP flat update of the fused trainer runs the optimizer-slab kernel
(``csrc/slab_update.cu``). All are built with ``nvcc`` at first use —
never at import.

With no context entered, arrays and entry points are on ``gpu(0)``; enter
``with mx.cpu():`` or pass ``device="cpu"`` for the host. With no CUDA
device and no explicit CPU context they raise.

Usage mirrors ``import mxnet as mx``::

    import mxnet_tpu_torch as mx
    a = mx.nd.ones((2, 3), ctx=mx.gpu())
    net = mx.sym.FullyConnected(mx.sym.Variable('data'), num_hidden=10)
    exe = net.simple_bind(mx.gpu(), data=(4, 3))
"""
from __future__ import annotations

from . import context, telemetry  # noqa: F401
from .base import MXNetError, __version__  # noqa: F401
from .context import Context, cpu, current_context, default_device, gpu, num_devices  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import random  # noqa: F401
from . import random as rnd  # noqa: F401
from . import autograd  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from . import executor  # noqa: F401
from .executor import Executor  # noqa: F401
from .attribute import AttrScope  # noqa: F401
from .name import NameManager, Prefix  # noqa: F401
from . import rtc  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from . import lr_scheduler, metric, optimizer  # noqa: F401
from . import io  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import callback, model  # noqa: F401
from . import parallel  # noqa: F401
from . import module  # noqa: F401
from . import module as mod  # noqa: F401
from . import predict  # noqa: F401
from . import serving  # noqa: F401
from . import resilience  # noqa: F401
from . import engine, image, io_pipeline, native, recordio  # noqa: F401
from . import rnn  # noqa: F401
from . import executor_manager  # noqa: F401
from . import contrib  # noqa: F401
from . import monitor, profiler  # noqa: F401
from . import visualization, visualization as viz  # noqa: F401
from . import operator  # noqa: F401  (registers Custom)
from . import log, libinfo, test_utils  # noqa: F401
from . import th, th as torch  # noqa: F401
