"""The C++ frontend of the PyTorch port (``mxnet_tpu_torch/cpp``) on the
CPU, with the gates of ``tests/test_cpp_package.py``: ``make`` builds the
two examples against the embedded CPython (``g++``, ``python3-config``),
``train_mlp --cpu`` trains above 0.90 with an exact checkpoint round trip
and the Predictor's accuracy equal to the executor's, ``lenet --cpu``
trains above 0.90 and prints the kernels' launch counters. The checkpoint
the binary writes loads in the JAX package's ``mx.nd.load`` with the
port's arrays, and without ``--cpu`` the binaries ask for the card, which
a host without one refuses."""
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPP = os.path.join(REPO, "mxnet_tpu_torch", "cpp")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("python3-config") is None,
    reason="no C++ toolchain / python3-config")


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    env.pop("MXTPU_AMP", None)
    return env


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("cpp")
    build = root / "build"
    r = subprocess.run(["make", "-C", CPP, "BUILD=%s" % build], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    out = root / "out"
    out.mkdir()
    mlp = subprocess.run([str(build / "train_mlp"), "--cpu", "--out", str(out)],
                         capture_output=True, text=True, timeout=600, env=_env())
    return {"build": build, "out": out, "mlp": mlp}


def test_cpp_frontend_trains_and_roundtrips(built):
    run = built["mlp"]
    assert run.returncode == 0, run.stdout + run.stderr
    out = run.stdout
    assert "checkpoint-roundtrip: exact" in out, out
    final = float(re.search(r"final-accuracy: ([0-9.]+)", out).group(1))
    assert final > 0.90, out
    assert float(re.search(r"predictor-accuracy: ([0-9.]+)", out).group(1)) == final
    assert "context: cpu(0)" in out


def test_cpp_checkpoint_loads_in_both_packages(built):
    path = str(built["out"] / "mxtpu_torch_cpp_mlp.params")
    with tmx.cpu():
        mine = {k: v.asnumpy() for k, v in tmx.nd.load(path).items()}
    theirs = {k: v.asnumpy() for k, v in jmx.nd.load(path).items()}
    assert sorted(mine) == sorted(theirs) == sorted(
        "arg:%s_%s" % (layer, kind) for layer in ("fc1", "fc2", "fc3")
        for kind in ("weight", "bias"))
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype == np.float32
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    with tmx.cpu():
        sym = tmx.sym.load(str(built["out"] / "mxtpu_torch_cpp_mlp-symbol.json"))
    assert sym.list_arguments() == jmx.sym.load(
        str(built["out"] / "mxtpu_torch_cpp_mlp-symbol.json")).list_arguments()


def test_cpp_lenet_convnet_trains(built):
    run = subprocess.run([str(built["build"] / "lenet"), "--cpu"], capture_output=True,
                         text=True, timeout=600, env=_env())
    assert run.returncode == 0, run.stdout + run.stderr
    acc = float(re.search(r"lenet val-accuracy: ([0-9.]+)", run.stdout).group(1))
    assert acc > 0.90
    # on the host the convolution gradients take the kernels' plain versions
    counts = dict(re.findall(r"(\w+)=(\d+)", run.stdout.split("kernel-launches:")[1]))
    assert counts["conv_bwd_filter"] == counts["conv_bwd_input"] == "0"


def test_cpp_defaults_to_the_card(built):
    """Without --cpu the binary runs on gpu(0): a host without a card
    refuses it, with no fallback to the host."""
    run = subprocess.run([str(built["build"] / "train_mlp"), "--out", str(built["out"])],
                         capture_output=True, text=True, timeout=300, env=_env())
    assert run.returncode != 0
    assert "final-accuracy" not in run.stdout
    assert re.search(r"CUDA|card|gpu", run.stderr, re.I), run.stderr[-2000:]


def test_header_embeds_only_the_port():
    text = open(os.path.join(CPP, "include", "mxtpu_torch", "mxtpu_torch.hpp")).read()
    modules = set(re.findall(r'PyImport_ImportModule\("([\w.]+)"\)', text))
    modules |= set(re.findall(r"import (\w+)", text))
    assert modules and all(m.split(".")[0] in ("mxnet_tpu_torch", "numpy") for m in modules), \
        modules
    for example in ("train_mlp.cpp", "lenet.cpp"):
        src = open(os.path.join(CPP, "example", example)).read()
        assert "sklearn" not in src and "jax" not in src
