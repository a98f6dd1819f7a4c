"""The port's host dependency engine (``mxnet_tpu_torch/engine.py`` and the
native engine of ``mxnet_tpu_torch/src/engine.cc``) on the CPU.

Every case of ``tests/test_engine.py`` runs on the port's Python, naive
and native engines: write serialization, read/write ordering, randomized
dependency chains (per-var write sequences stay monotone, the invariant of
the reference's threaded_engine_test.cc), ``wait_for_var`` and duplicate
vars refused. Also: ``get()`` follows ``MXNET_ENGINE_TYPE`` as the JAX
package's does, ``comm()`` is a Python engine, a raising op surfaces
through ``raise_pending`` and the priority heap runs the higher priority
first. Exact (orderings and counts)."""
import threading
import time

import numpy as np
import pytest

from mxnet_tpu import engine as jeng
from mxnet_tpu_torch import engine as eng_mod
from mxnet_tpu_torch.base import MXNetError


def _engines():
    engines = [eng_mod.ThreadedEngine(4), eng_mod.NaiveEngine()]
    try:
        from mxnet_tpu_torch.native import NativeEngine

        engines.append(NativeEngine(4))
    except Exception:
        pass
    return engines


ENGINES = _engines()


@pytest.mark.parametrize("engine", ENGINES, ids=lambda e: type(e).__name__)
def test_write_serialization(engine):
    v = engine.new_variable()
    state = {"x": 0}

    def bump():
        local = state["x"]
        time.sleep(0.0001)
        state["x"] = local + 1

    for _ in range(100):
        engine.push(bump, mutable_vars=[v])
    engine.wait_for_all()
    assert state["x"] == 100


@pytest.mark.parametrize("engine", ENGINES, ids=lambda e: type(e).__name__)
def test_read_write_ordering(engine):
    v = engine.new_variable()
    order = []

    def w1():
        time.sleep(0.02)
        order.append("w1")

    engine.push(w1, mutable_vars=[v])
    engine.push(lambda: order.append("r1"), const_vars=[v])
    engine.push(lambda: order.append("r2"), const_vars=[v])
    engine.push(lambda: order.append("w2"), mutable_vars=[v])
    engine.wait_for_all()
    assert order[0] == "w1" and order[-1] == "w2"
    assert set(order[1:3]) == {"r1", "r2"}


@pytest.mark.parametrize("engine", ENGINES, ids=lambda e: type(e).__name__)
def test_randomized_dependency_chains(engine):
    rng = np.random.RandomState(0)
    n_vars = 6
    vars_ = [engine.new_variable() for _ in range(n_vars)]
    logs = {i: [] for i in range(n_vars)}
    counter = {i: 0 for i in range(n_vars)}
    lock = threading.Lock()

    def make_op(writes, seq):
        def op():
            with lock:
                for w in writes:
                    logs[w].append(seq[w])

        return op

    for _ in range(200):
        widx = list(rng.choice(n_vars, size=rng.randint(1, 3), replace=False))
        ridx = [i for i in rng.choice(n_vars, size=2, replace=False) if i not in widx]
        seq = {}
        for w in widx:
            counter[w] += 1
            seq[w] = counter[w]
        engine.push(make_op(widx, seq), const_vars=[vars_[i] for i in ridx],
                    mutable_vars=[vars_[i] for i in widx])
    engine.wait_for_all()
    for i in range(n_vars):
        assert logs[i] == sorted(logs[i]) == list(range(1, counter[i] + 1)), i


def test_wait_for_var():
    engine = eng_mod.ThreadedEngine(2)
    v = engine.new_variable()
    done = []
    engine.push(lambda: (time.sleep(0.05), done.append(1)), mutable_vars=[v])
    engine.wait_for_var(v)
    assert done == [1]


def test_duplicate_vars_rejected():
    engine = eng_mod.ThreadedEngine(2)
    v = engine.new_variable()
    with pytest.raises(MXNetError):
        engine.push(lambda: None, const_vars=[v], mutable_vars=[v])
    with pytest.raises(MXNetError):
        engine.push(lambda: None, mutable_vars=[v, v])


def test_raising_op_surfaces_through_raise_pending():
    engine = eng_mod.ThreadedEngine(2)
    v = engine.new_variable()

    def boom():
        raise ValueError("op failed")

    engine.push(boom, mutable_vars=[v])
    engine.push(lambda: None, mutable_vars=[v])  # the worker survived
    engine.wait_for_all()
    with pytest.raises(ValueError, match="op failed"):
        engine.raise_pending()
    engine.raise_pending()  # cleared


def test_priority_heap_runs_higher_first():
    engine = eng_mod.ThreadedEngine(1)
    gate = threading.Event()
    engine.push(gate.wait)  # hold the single worker
    trace = engine.start_trace()
    for p in (0, 5, -3, 2):
        engine.push(lambda: None, priority=p, name="p%d" % p)
    gate.set()
    engine.wait_for_all()
    engine.stop_trace()
    assert [t["name"] for t in trace if t["name"]] == ["p5", "p2", "p0", "p-3"]


@pytest.mark.parametrize("etype,port_cls,jax_cls", [
    ("NaiveEngine", "NaiveEngine", "NaiveEngine"),
    ("ThreadedEngine", "ThreadedEngine", "ThreadedEngine"),
    ("ThreadedEnginePerDevice", "NativeEngine", "NativeEngine"),
])
def test_get_follows_engine_type_as_jax(monkeypatch, etype, port_cls, jax_cls):
    monkeypatch.setenv("MXNET_ENGINE_TYPE", etype)
    for mod in (eng_mod, jeng):
        monkeypatch.setattr(mod, "_ENGINE", None)
        monkeypatch.setattr(mod, "_COMM_ENGINE", None)
    assert type(eng_mod.get()).__name__ == port_cls
    assert type(jeng.get()).__name__ == jax_cls
    assert type(eng_mod.comm()).__name__ == type(jeng.comm()).__name__
    assert eng_mod.get() is eng_mod.get()
