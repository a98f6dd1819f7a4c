"""Library information of the port (counterpart of ``mxnet_tpu/libinfo.py``,
the reference's ``python/mxnet/libinfo.py``).

The reference locates ``libmxnet.so``; the port's native code is what it
builds itself beside the package: the CUDA kernels' libraries
(``build/kernels/``, by ``ops/_build.py`` at first use, one per source and
hash) and the native host library (``build/native/libmxtpu_torch.so``, by
``native.py``). ``find_lib_path`` lists those that are built.
"""
from __future__ import annotations

from .base import __version__  # noqa: F401


def find_lib_path():
    """Paths of the built native libraries: the kernel libraries under
    ``build/kernels/`` and the native host library, where they exist (none
    on a fresh checkout: both are built at first use)."""
    from . import native
    from .ops import _build

    libs = []
    if _build.BUILD_DIR.is_dir():
        libs.extend(str(p) for p in sorted(_build.BUILD_DIR.glob("*.so")))
    if native.LIB_PATH.is_file():
        libs.append(str(native.LIB_PATH))
    return libs
