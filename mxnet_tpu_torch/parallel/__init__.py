"""Parallelism over a mesh of logical ranks on one device (counterpart of
``mxnet_tpu/parallel``): ``make_mesh``, the fused data-parallel
``ShardedTrainStep``, sequence-parallel ring attention, the Switch-MoE FFN
with its expert axis, and the GPipe pipeline."""
from .mesh import Mesh, axis_size, dp_sharding, make_mesh, replicated_sharding  # noqa: F401
from .train_step import ShardedTrainStep, host_state  # noqa: F401
from .ring_attention import ring_attention, sequence_parallel_attention  # noqa: F401
from .moe import init_moe_params, moe_partition_specs, switch_moe  # noqa: F401
from .pipeline import pipeline_stages, pipelined_loss  # noqa: F401
