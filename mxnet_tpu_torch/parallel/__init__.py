"""Parallelism over a mesh of logical ranks on one device in each process
(counterpart of ``mxnet_tpu/parallel``): ``make_mesh``, the process group
and its host collectives, the fused data-parallel ``ShardedTrainStep``,
sequence-parallel ring attention, the Switch-MoE FFN with its expert axis,
the GPipe pipeline and the heartbeat files."""
from .mesh import (AxisGroup, Mesh, all_gather, allreduce_sum, axis_group,  # noqa: F401
                   axis_size, barrier, broadcast_from_root, dp_sharding, init_distributed,
                   make_mesh, ppermute, reduce_scatter_sum, replicated_sharding)
from .train_step import ShardedTrainStep, host_state  # noqa: F401
from .ring_attention import ring_attention, sequence_parallel_attention  # noqa: F401
from .moe import init_moe_params, moe_partition_specs, switch_moe  # noqa: F401
from .pipeline import pipeline_stages, pipelined_loss  # noqa: F401
from . import heartbeat  # noqa: F401
