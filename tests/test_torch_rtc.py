"""mx.rtc of the PyTorch port on the CPU, without NVRTC: the decorated
CUDA C source for given names, shapes and dtypes (held to a fixed text),
the dtype mapping, the argument checks, the MXNetError for CPU arrays,
and the plain versions of the four kernel bodies in ``rtc_kernels``
(against numpy and the port's ``sgd_mom_update``). The kernels themselves
run on the card: tests/test_torch_cuda_kernels.py."""
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
