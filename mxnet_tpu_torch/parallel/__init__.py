"""Data-parallel training over a mesh of logical ranks on one device
(counterpart of ``mxnet_tpu/parallel``): ``make_mesh`` and the fused
``ShardedTrainStep``. MoE, pipeline and ring attention wait."""
from .mesh import Mesh, dp_sharding, make_mesh, replicated_sharding  # noqa: F401
from .train_step import ShardedTrainStep, host_state  # noqa: F401
