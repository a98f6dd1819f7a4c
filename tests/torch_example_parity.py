"""Helpers of the ``test_torch_examples_*.py`` files: the JAX package's
example modules (``examples/*.py``), and the parity of an example's symbol
and of its first training steps between the two packages on the CPU."""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one thread for a module's tiny models: the suite's workers
    share the host's cores, and OpenMP teams spinning on a crowded host
    slow every worker (restored after)."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def jax_example(name):
    """``examples/<name>.py`` as a module (its ``from common import``
    resolves to ``examples/common.py``)."""
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    spec = importlib.util.spec_from_file_location("jax_example_" + name,
                                                  os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fresh(pkg, build, *args, **kwargs):
    """``build(*args)`` inside a fresh NameManager of ``pkg``: auto-named
    nodes count up per process."""
    with pkg.name.NameManager():
        return build(*args, **kwargs)


def assert_same_symbol(tsym, jsym, **shapes):
    """Arguments, outputs, auxiliary states and inferred shapes equal."""
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    got = [[tuple(s) for s in g] for g in tsym.infer_shape(**shapes)]
    want = [[tuple(s) for s in g] for g in jsym.infer_shape(**shapes)]
    assert got == want, (got, want)


def of_max(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, "%s: max err %.3g > %g of max %.3g" % (what, err, tol, scale)


def _module(pkg, sym, data, label, data_names, label_names):
    mod = pkg.mod.Module(sym, context=pkg.cpu(), data_names=data_names,
                         label_names=label_names or None)
    mod.bind(data_shapes=[(k, data[k].shape[1:]) for k in data_names],
             label_shapes=[(k, label[k].shape[1:]) for k in label_names] or None)
    return mod


def ce(outs, labels):
    """Mean cross entropy of softmax outputs [N, C] (or [N, T, C] flattened
    against [N, T] labels) over every head."""
    total = 0.0
    for p, y in zip(outs, labels):
        p = p.reshape(-1, p.shape[-1]).astype(np.float64)
        y = y.reshape(-1).astype(np.int64)
        total += float(-np.log(np.maximum(p[np.arange(len(y)), y], 1e-30)).mean())
    return total


def mse(outs, labels):
    return float(np.mean((outs[0].astype(np.float64) - labels[0].reshape(outs[0].shape)) ** 2))


def mean_out(outs, labels):
    """A MakeLoss head's loss: its output's mean."""
    return float(np.mean(outs[0].astype(np.float64)))


def train_steps(tsym, jsym, data, label, optimizer, opt_params, init, loss, tol=1e-5,
                rescale=True):
    """The first steps of a Module on the same batches in both packages.

    ``data`` / ``label``: name -> array [steps, batch, ...]. The JAX
    Module draws the initial parameters (``np.random.seed(0)`` first, as
    the examples do), the port's takes them as numpy. Each step is forward
    (training), backward and update; ``loss(outputs, labels)`` of each
    step's forward is held within ``tol`` relative, and the first forward's
    outputs (the same parameters in both) within ``tol`` of their max.
    Returns the JAX losses."""
    data_names, label_names = list(data), list(label)
    batch = next(iter(data.values())).shape[1]
    opt_params = dict(opt_params)
    if rescale:
        opt_params.setdefault("rescale_grad", 1.0 / batch)
    np.random.seed(0)
    jmx.random.seed(0)
    jmod = _module(jmx, jsym, data, label, data_names, label_names)
    jmod.init_params(init)
    arg, aux = jmod.get_params()
    arg = {k: v.asnumpy() for k, v in arg.items()}
    aux = {k: v.asnumpy() for k, v in aux.items()}
    jmod.init_optimizer(optimizer=optimizer, optimizer_params=opt_params)
    want_losses, got_losses = [], []
    with tmx.cpu():
        tmod = _module(tmx, tsym, data, label, data_names, label_names)
        tmod.init_params(arg_params={k: tmx.nd.array(v) for k, v in arg.items()},
                         aux_params={k: tmx.nd.array(v) for k, v in aux.items()})
        tmod.init_optimizer(optimizer=optimizer, optimizer_params=opt_params)
        steps = next(iter(data.values())).shape[0]
        for t in range(steps):
            labels = [label[k][t] for k in label_names]
            jb = jmx.io.DataBatch([jmx.nd.array(data[k][t]) for k in data_names],
                                  [jmx.nd.array(v) for v in labels])
            tb = tmx.io.DataBatch([tmx.nd.array(data[k][t]) for k in data_names],
                                  [tmx.nd.array(v) for v in labels])
            for mod, b in ((jmod, jb), (tmod, tb)):
                mod.forward(b, is_train=True)
                mod.backward()
                mod.update()
            want = [o.asnumpy() for o in jmod.get_outputs()]
            got = [o.asnumpy() for o in tmod.get_outputs()]
            if t == 0:
                for i, (g, w) in enumerate(zip(got, want)):
                    of_max(g, w, tol, "first forward, output %d" % i)
            want_losses.append(loss(want, labels))
            got_losses.append(loss(got, labels))
    np.testing.assert_allclose(got_losses, want_losses, rtol=tol, atol=0)
    return want_losses


def batches(X, steps, batch):
    """The first ``steps`` batches of ``X`` as [steps, batch, ...]."""
    X = np.asarray(X)
    return X[:steps * batch].reshape((steps, batch) + X.shape[1:])


def run_port(example, argv):
    """The port's example run on the host: ``run(parse_args(argv + ["--ctx",
    "cpu"]))`` with the host as the default context."""
    args = example.parse_args(list(argv) + ["--ctx", "cpu"])
    with tmx.cpu():
        return example.run(args)
