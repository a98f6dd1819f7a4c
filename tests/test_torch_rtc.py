"""mx.rtc of the PyTorch port on the CPU, without NVRTC: the decorated
CUDA C source for given names, shapes and dtypes (held to a fixed text),
the dtype mapping, the argument checks, the MXNetError for CPU arrays,
the plain versions of the four kernel bodies in ``rtc_kernels``
(against numpy and the port's ``sgd_mom_update``), and the push path with
NVRTC and the CUDA driver replaced by recording fakes: launch records, every
check of a push, and the launch's arguments and context. The kernels
themselves run on the card: tests/test_torch_cuda_kernels.py."""
import ctypes

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import rtc, rtc_kernels

EXPECTED = """#include <cuda_bf16.h>
extern "C" __global__ void madd(const float* a, const __nv_bfloat16* b, float* out)
{
    typedef float a_t;
    [[maybe_unused]] constexpr long long a_size = 512LL;
    [[maybe_unused]] constexpr int a_ndim = 2;
    [[maybe_unused]] constexpr long long a_shape0 = 4LL;
    [[maybe_unused]] constexpr long long a_shape1 = 128LL;
    typedef __nv_bfloat16 b_t;
    [[maybe_unused]] constexpr long long b_size = 128LL;
    [[maybe_unused]] constexpr int b_ndim = 1;
    [[maybe_unused]] constexpr long long b_shape0 = 128LL;
    typedef float out_t;
    [[maybe_unused]] constexpr long long out_size = 512LL;
    [[maybe_unused]] constexpr int out_ndim = 2;
    [[maybe_unused]] constexpr long long out_shape0 = 4LL;
    [[maybe_unused]] constexpr long long out_shape1 = 128LL;
    out[0] = a[0] * (float)b[0];
}
"""


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def test_decorated_source_text():
    got = rtc.decorate("madd", [("a", (4, 128), torch.float32), ("b", (128,), torch.bfloat16)],
                       [("out", (4, 128), torch.float32)], "\n    out[0] = a[0] * (float)b[0];\n")
    assert got == EXPECTED
    half = rtc.decorate("k", [("x", (2,), torch.float16)], [("y", (), torch.int64)], "y[0] = 1;")
    assert half.startswith("#include <cuda_fp16.h>\nextern \"C\" __global__ void k("
                           "const __half* x, long long* y)")
    assert "constexpr long long y_size = 1LL;" in half and "y_ndim = 0;" in half


def test_dtype_mapping():
    want = {torch.float32: "float", torch.float16: "__half", torch.bfloat16: "__nv_bfloat16",
            torch.float64: "double", torch.int32: "int", torch.int64: "long long",
            torch.int8: "signed char", torch.uint8: "unsigned char"}
    for dt, ct in want.items():
        assert rtc.ctype_of(dt) == ct
    for dt in (torch.bool, torch.int16, torch.complex64):
        with pytest.raises(tmx.MXNetError, match="no CUDA C type"):
            rtc.ctype_of(dt)


def test_argument_checks():
    a, b = tmx.nd.ones((2, 3)), tmx.nd.ones((3,))
    assert rtc.check_arrays("k", ["a", "b"], [a, b], "inputs") == [
        ("a", (2, 3), torch.float32), ("b", (3,), torch.float32)]
    with pytest.raises(tmx.MXNetError, match="wrong number of arrays"):
        rtc.check_arrays("k", ["a"], [a, b], "inputs")
    with pytest.raises(tmx.MXNetError, match="not an NDArray"):
        rtc.check_arrays("k", ["a"], [np.ones(3)], "inputs")
    with pytest.raises(tmx.MXNetError, match="no CUDA C type"):
        rtc.check_arrays("k", ["a"], [tmx.nd.NDArray(torch.ones(3, dtype=torch.bool))],
                         "inputs")
    with pytest.raises(tmx.MXNetError, match="not contiguous"):
        rtc.check_arrays("k", ["a"], [tmx.nd.NDArray(torch.ones(4, 4).t())], "outputs")
    assert rtc.launch_dims((4,), None) == ((4, 1, 1), (1, 1, 1))
    assert rtc.launch_dims((2, 3, 1), (32, 32, 1)) == ((2, 3, 1), (32, 32, 1))
    for grid, block in (((1, 1, 1), (1025, 1, 1)), ((1, 1, 1), (64, 32, 1)),
                        ((1, 1, 1), (1, 1, 65)), ((0, 1, 1), (1, 1, 1)),
                        ((1, 1, 1, 1), (1, 1, 1)), ((1, 70000, 1), (1, 1, 1))):
        with pytest.raises(tmx.MXNetError):
            rtc.launch_dims(grid, block)


def test_cpu_arrays_raise_before_any_compile():
    x, y = tmx.nd.ones((8, 128)), tmx.nd.zeros((8, 128))
    before = rtc.Rtc.compiles
    for make in (lambda: rtc.Rtc("axpb", [("x", x)], [("y", y)], rtc_kernels.AXPB[3]),
                 lambda: tmx.rtc.rtc("axpb", [("x", x)], [("y", y)], rtc_kernels.AXPB[3]),
                 lambda: rtc_kernels.make(rtc_kernels.MADD, [x, x], [y])):
        with pytest.raises(tmx.MXNetError, match="host"):
            make()
    with pytest.raises(tmx.MXNetError, match="host"):
        rtc.device_of("k", [x, y])
    assert rtc.Rtc.compiles == before


def test_plain_versions():
    """The plain versions: test_rtc.py's values, and kernel (d)'s
    SGD-momentum against the port's sgd_mom_update on its constants."""
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    np.testing.assert_allclose(rtc_kernels.axpb_plain(x).numpy(), x.numpy() * 2 + 1, rtol=1e-6)
    a, b = (torch.from_numpy(np.random.RandomState(i).rand(4, 128).astype(np.float32))
            for i in (0, 1))
    np.testing.assert_allclose(rtc_kernels.madd_plain(a, b).numpy(),
                               a.numpy() * b.numpy() + a.numpy(), rtol=1e-6)
    np.testing.assert_allclose(rtc_kernels.exp5_plain(a).numpy(), np.exp(5 * a.numpy()),
                               rtol=1e-6)
    assert rtc_kernels.axpb_plain(x.to(torch.bfloat16)).dtype == torch.bfloat16
    name, ins, outs, body = rtc_kernels.sgd_mom_source(0.1, 0.9, 1e-4, 0.03125)
    assert (name, ins, outs) == ("sgd_mom", ("grad",), ("weight", "mom"))
    for literal in ("1.000000000e-01f", "9.000000000e-01f", "1.000000000e-04f",
                    "3.125000000e-02f"):
        assert literal in body
    # the body's f32 arithmetic, step by step in numpy, is sgd_mom_update's
    w, g, m = (np.random.RandomState(i).randn(50).astype(np.float32) for i in (2, 3, 4))
    f = np.float32
    gg = g * f(0.03125) + f(1e-4) * w
    mm = f(0.9) * m - f(0.1) * gg
    weight, mom = tmx.nd.array(w), tmx.nd.array(m)
    tmx.nd.sgd_mom_update(weight, tmx.nd.array(g), mom, out=weight, lr=0.1, momentum=0.9,
                          wd=1e-4, rescale_grad=0.03125)
    np.testing.assert_allclose(mom.asnumpy(), mm, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(weight.asnumpy(), w + mm, rtol=1e-6, atol=1e-7)
    assert rtc_kernels.grid_stride_dims(1000) == ((4, 1, 1), (256, 1, 1))
    assert rtc_kernels.grid_stride_dims(10**9) == ((1056, 1, 1), (256, 1, 1))


class _CudaStandIn:
    """What ``Rtc.push`` reads of a CUDA tensor, without a card: shape,
    dtype, device, contiguity and the data pointer."""

    def __init__(self, shape, ptr, dtype=torch.float32, index=0, contiguous=True):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", index)
        self._ptr, self._contiguous = ptr, contiguous

    def get_device(self):
        return self.device.index

    def is_contiguous(self):
        return self._contiguous

    def data_ptr(self):
        return self._ptr


def _nd(shape, ptr, **kw):
    return tmx.nd.NDArray(_CudaStandIn(shape, ptr, **kw))


@pytest.fixture
def fake_cuda(monkeypatch):
    """NVRTC and the CUDA driver replaced by recording fakes: compiles, loads
    (name, device index) and launches (record, pointers)."""
    calls = {"compile": [], "load": [], "launch": []}
    monkeypatch.setattr(rtc._nvrtc, "compile_cubin",
                        lambda source, filename: calls["compile"].append(source) or b"cubin")
    monkeypatch.setattr(rtc._nvrtc, "load_function", lambda cubin, name, index: (
        calls["load"].append((name, index)) or "fn%d" % len(calls["load"])))
    monkeypatch.setattr(rtc._nvrtc, "launch", lambda record, pointers: (
        calls["launch"].append((record, list(pointers)))))
    return calls


def _madd(fake_cuda):
    k = rtc.Rtc("madd", [("a", _nd((4, 128), 0x100)), ("b", _nd((128,), 0x200))],
                [("out", _nd((4, 128), 0x300))], rtc_kernels.MADD[3])
    assert len(fake_cuda["compile"]) == 1 and fake_cuda["load"] == [("madd", 0)]
    return k


def test_push_reuses_one_launch_record_per_key(fake_cuda):
    """A push hands the CUDA driver the data pointers, inputs then outputs,
    through the launch record of its key (shapes, dtypes, devices, grid,
    block): the same key reuses the record with the new pointers; a
    change of shape, dtype, grid, block or device makes a new record."""
    k = _madd(fake_cuda)
    launches = rtc.Rtc.launches
    got = k.push([_nd((4, 128), 0x100), _nd((128,), 0x200)], [_nd((4, 128), 0x300)],
                 (2, 1, 1), (256, 1, 1))
    assert len(got) == 1 and rtc.Rtc.launches == launches + 1
    record, ptrs = fake_cuda["launch"][-1]
    assert ptrs == [0x100, 0x200, 0x300]
    assert (record.fn, record.index, record.grid, record.block, len(record.slots)) == (
        "fn1", 0, (2, 1, 1), (256, 1, 1), 3)
    k.push([_nd((4, 128), 0x400), _nd((128,), 0x500)], [_nd((4, 128), 0x600)],
           [2, 1, 1], np.array([256, 1, 1]))  # the same dimensions as a list and an array
    again, ptrs = fake_cuda["launch"][-1]
    assert again is record and ptrs == [0x400, 0x500, 0x600] and len(k._records) == 1
    changes = [
        ((8, 128), (128,), (4, 128), torch.float32, 0, (2, 1, 1), (256, 1, 1)),  # shape
        ((4, 128), (128,), (4, 128), torch.bfloat16, 0, (2, 1, 1), (256, 1, 1)),  # dtype
        ((4, 128), (128,), (4, 128), torch.float32, 0, (3, 1, 1), (256, 1, 1)),  # grid
        ((4, 128), (128,), (4, 128), torch.float32, 0, (2, 1, 1), (128, 1, 1)),  # block
        ((4, 128), (128,), (4, 128), torch.float32, 1, (2, 1, 1), (256, 1, 1)),  # device
    ]
    for i, (sa, sb, so, dt, dev, grid, block) in enumerate(changes):
        k.push([_nd(sa, 1, dtype=dt, index=dev), _nd(sb, 2, dtype=dt, index=dev)],
               [_nd(so, 3, dtype=dt, index=dev)], grid, block)
        new, ptrs = fake_cuda["launch"][-1]
        assert new is not record and ptrs == [1, 2, 3] and len(k._records) == 2 + i
        assert (new.index, new.grid, new.block) == (dev, grid, block)
    # shape and dtype compiled anew (the grid, block and device changes did not)
    assert len(fake_cuda["compile"]) == 3
    assert fake_cuda["load"][-1] == ("madd", 1)
    assert rtc.Rtc.launches == launches + 2 + len(changes)


@pytest.mark.parametrize("case,match", [
    ("count_in", r"wrong number of arrays: 1 inputs for \['a', 'b'\]"),
    ("count_out", r"wrong number of arrays: 2 outputs for \['out'\]"),
    ("ndarray", "inputs b is not an NDArray"),
    ("dtype", "dtype bool has no CUDA C type"),
    ("contiguous", "outputs out is not contiguous"),
    ("host", "not on the host"),
    ("devices", "several devices"),
    ("grid", r"grid \(70000, 70000, 1\) is past the card's limits"),
    ("block", r"block \(64, 32, 1\) is more than 1024 threads"),
])
def test_push_keeps_every_check(fake_cuda, case, match):
    """Each check of a push still raises its MXNetError on every push,
    before any launch: a key that fails never gets a launch record."""
    k = _madd(fake_cuda)
    a, b, out = _nd((4, 128), 1), _nd((128,), 2), _nd((4, 128), 3)
    ins, outs, grid, block = [a, b], [out], (1, 1, 1), (128, 1, 1)
    if case == "count_in":
        ins = [a]
    elif case == "count_out":
        outs = [out, out]
    elif case == "ndarray":
        ins = [a, np.ones(128, np.float32)]
    elif case == "dtype":
        ins = [a, _nd((128,), 2, dtype=torch.bool)]
    elif case == "contiguous":
        outs = [_nd((4, 128), 3, contiguous=False)]
    elif case == "host":
        ins = [a, tmx.nd.ones((128,))]
    elif case == "devices":
        outs = [_nd((4, 128), 3, index=1)]
    elif case == "grid":
        grid = (70000, 70000, 1)
    elif case == "block":
        block = (64, 32, 1)
    for _ in range(2):
        with pytest.raises(tmx.MXNetError, match=match):
            k.push(ins, outs, grid, block)
    assert fake_cuda["launch"] == [] and k._records == {}


class _FakeDriver:
    """The CUDA driver calls ``_nvrtc.launch`` makes, recorded: the context
    current on the thread, context switches, and each launch's arguments
    with the pointer values its ``void**`` array holds."""

    def __init__(self, current, rc=0):
        self.current, self.rc, self.calls = current, rc, []

    def cuCtxGetCurrent(self, ref):
        ref._obj.value = self.current
        return 0

    def cuCtxSetCurrent(self, ctx):
        self.current = getattr(ctx, "value", ctx)
        self.calls.append(("set", self.current))
        return 0

    def cuLaunchKernel(self, fn, gx, gy, gz, bx, by, bz, smem, stream, params, extra):
        ptrs = [ctypes.c_void_p.from_address(params[i]).value for i in range(3)]
        self.calls.append(("launch", fn, (gx, gy, gz), (bx, by, bz), smem, stream, ptrs))
        return self.rc

    def cuGetErrorString(self, rc, ref):
        return 0


@pytest.mark.parametrize("current", [0x77, 0x99, None])
def test_launch_fills_the_record_and_keeps_the_thread_context(monkeypatch, current):
    """``_nvrtc.launch`` hands ``cuLaunchKernel`` the record's function,
    grid and block, the stream of the device and the pointers written into
    the record's argument array. With the device's primary context (0x77)
    current it switches nothing; with another one or none, it makes the
    primary one current for the launch and restores the previous one after
    it, also when the launch fails."""
    from mxnet_tpu_torch import _nvrtc

    monkeypatch.setattr(_nvrtc, "_primary_context", lambda index: ctypes.c_void_p(0x77))
    monkeypatch.setattr(_nvrtc, "_raw_stream", lambda index: 0x55 + index)
    record = _nvrtc.LaunchRecord(ctypes.c_void_p(0x10), 1, (4, 1, 1), (256, 1, 1), 3)
    for rc in (0, 700):
        lib = _FakeDriver(current, rc)
        monkeypatch.setitem(_nvrtc._libs, "cuda", lib)
        if rc:
            with pytest.raises(tmx.MXNetError, match="cuLaunchKernel: CUDA driver error 700"):
                _nvrtc.launch(record, [0x100, 0x200, 0x300])
        else:
            _nvrtc.launch(record, [0x100, 0x200, 0x300])
        launch = ("launch", record.fn, (4, 1, 1), (256, 1, 1), 0, 0x56, [0x100, 0x200, 0x300])
        want = [launch] if current == 0x77 else [("set", 0x77), launch, ("set", current)]
        assert lib.calls == want and lib.current == current
