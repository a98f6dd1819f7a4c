"""Test configuration: force an 8-device virtual CPU mesh.

Mirrors the reference's trick of using multiple CPU contexts as fake
devices (tests/python/unittest/test_multi_device_exec.py) — here via
XLA's host-platform device-count flag, set BEFORE jax initializes.
The jax.config update routes around any accelerator plugin so the suite
never depends on TPU availability.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from __graft_entry__ import _force_cpu_mesh_platform

_force_cpu_mesh_platform(8)

import jax

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _seed():
    np.random.seed(0)
    import mxnet_tpu as mx

    mx.random.seed(0)
    yield


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "timeout(seconds): SIGALRM deadline for one test — guards the "
        "multi-process input-pipeline tests against a hung decode pool "
        "taking the whole tier-1 run down with it")
    config.addinivalue_line(
        "markers",
        "slow: heavyweight multi-process / subprocess-relaunch / "
        "SIGKILL-chain tests excluded from the tier-1 budget "
        "(-m 'not slow'); the full suite runs them nightly — see "
        "tests/README.md")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the PyTorch port's hand-written "
        "kernels); skips without one")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    """Minimal in-tree stand-in for pytest-timeout (not vendored here):
    an alarm-based deadline honored on the main thread. A test that
    deadlocks on a worker queue fails with a clear message instead of
    eating the suite's global `timeout` budget."""
    import signal

    marker = item.get_closest_marker("timeout")
    seconds = int(marker.args[0]) if marker and marker.args else 0
    if seconds <= 0 or not hasattr(signal, "SIGALRM"):
        return (yield)

    def _expired(signum, frame):
        raise TimeoutError(
            "test exceeded its %ds timeout marker" % seconds)

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(seconds)
    try:
        return (yield)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
