"""Module API of the PyTorch port (counterpart of ``mxnet_tpu/module``):
BaseModule, Module and the executor group. BucketingModule,
SequentialModule, PythonModule and MutableModule are not ported yet."""
from .base_module import BaseModule  # noqa: F401
from .executor_group import DataParallelExecutorGroup  # noqa: F401
from .module import Module  # noqa: F401
