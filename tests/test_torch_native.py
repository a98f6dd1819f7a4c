"""The port's native host library (``mxnet_tpu_torch/native.py`` over
``mxnet_tpu_torch/src/*.cc``) on the CPU.

Every case of ``tests/test_native.py`` runs on the port (the mmap reader
against the Python writer, the indexed reader's native path with a
key-sorted .idx, the CSV parser, the MNIST header reader, the native
engine refusing duplicate vars), and the native JPEG decode of
``tests/test_io.py`` against PIL (within one level: the system libjpeg
and PIL's may be different builds). The PNG path added in the port is
held to PIL bit for bit for every row filter (each PNG below is written
with one filter type on every row, or all five in turn) and for gray,
RGB and RGBA, into RGB and into gray; 16-bit, palette, gray+alpha and
interlaced PNGs fall through to PIL. The library is built under
``build/native/``, never in the package, and reads files the JAX package
writes."""
import ctypes
import io as _io
import os
import struct

import numpy as np
import pytest

from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import native, recordio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.tools.input_bench import png_bytes

pytestmark = pytest.mark.skipif(not native.available(), reason="no g++ on this host")


def _pil(buf, gray):
    from PIL import Image

    return np.asarray(Image.open(_io.BytesIO(buf)).convert("L" if gray else "RGB"))


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth", "all"])
@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
def test_png_decode_is_bit_exact_against_pil(filters, channels):
    pytest.importorskip("PIL")
    rng = np.random.RandomState(channels * 10 + filters[0])
    shape = (23, 31) if channels == 1 else (23, 31, channels)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    buf = png_bytes(img, filters)
    for gray in (False, True):
        got = native.imdecode_png(buf, gray=gray)
        want = _pil(buf, gray)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(recordio._imdecode_np(buf, 0 if gray else 1), want)
    if channels == 3:
        np.testing.assert_array_equal(native.imdecode_png(buf), img)


def test_png_written_by_pil_decodes_natively():
    pytest.importorskip("PIL")
    from PIL import Image

    img = np.random.RandomState(2).randint(0, 256, (40, 33, 3)).astype(np.uint8)
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG", optimize=True)
    np.testing.assert_array_equal(native.imdecode_png(buf.getvalue()), img)


def test_other_pngs_fall_through_to_pil():
    pytest.importorskip("PIL")
    from PIL import Image

    rng = np.random.RandomState(3)
    cases = {
        "palette": Image.fromarray(rng.randint(0, 255, (9, 11, 3)).astype(np.uint8)).convert(
            "P", palette=Image.ADAPTIVE, colors=16),
        "gray16": Image.fromarray(rng.randint(0, 65535, (9, 11)).astype(np.uint16)),
        "gray_alpha": Image.fromarray(rng.randint(0, 255, (9, 11, 2)).astype(np.uint8), "LA"),
    }
    for name, im in cases.items():
        buf = _io.BytesIO()
        im.save(buf, format="PNG")
        data = buf.getvalue()
        assert native.imdecode_png(data) is None, name
        np.testing.assert_array_equal(recordio._imdecode_np(data), _pil(data, False))
    buf = _io.BytesIO()
    Image.fromarray(rng.randint(0, 255, (9, 11, 3)).astype(np.uint8)).save(
        buf, format="PNG", interlace=1)
    data = buf.getvalue()
    if data[28] == 1:  # this PIL wrote Adam7
        assert native.imdecode_png(data) is None
    np.testing.assert_array_equal(recordio._imdecode_np(data), _pil(data, False))
    assert native.imdecode_png(b"\x89PNG\r\n\x1a\n" + b"\0" * 40) is None  # no IHDR


def test_undecodable_payload_raises_or_names_the_decoders(monkeypatch):
    with pytest.raises((OSError, MXNetError)):
        recordio._imdecode_np(b"definitely not an image")


def test_native_jpeg_decode_matches_pil():
    pytest.importorskip("PIL")
    from PIL import Image

    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (48, 64, 3)).astype(np.uint8)
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=92)
    data = buf.getvalue()
    nat = native.imdecode_jpeg(data)
    if nat is not None:  # a host without libjpeg tests the fallback below
        diff = np.abs(nat.astype(int) - _pil(data, False).astype(int))
        assert diff.max() <= 1, diff.max()
        assert native.imdecode_jpeg(data, gray=True).shape == (48, 64)
    assert recordio._imdecode_np(data).shape == (48, 64, 3)
    # the JAX package decodes the same bytes through its own libjpeg path
    np.testing.assert_array_equal(recordio._imdecode_np(data), jrec._imdecode_np(data))


def test_library_builds_outside_the_package():
    assert native.LIB_PATH.exists()
    assert native.LIB_PATH.parent.name == "native"
    assert native.LIB_PATH.parent.parent.name == "build"
    pkg = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
    assert not [f for f in os.listdir(os.path.join(pkg, "src")) if f.endswith(".so")]


# ---------------------------------------------------------------------------
# tests/test_native.py, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", [recordio, jrec], ids=["port_file", "jax_file"])
def test_native_recordio_interop(tmp_path, writer):
    path = str(tmp_path / "x.rec")
    w = writer.MXRecordIO(path, "w")
    payloads = [b"abc" * (i + 1) for i in range(17)] + [b""]
    for p in payloads:
        w.write(p)
    w.close()
    r = native.NativeRecordReader(path)
    assert len(r) == 18
    for i, p in enumerate(payloads):
        assert r.read(i) == p
    with pytest.raises(IndexError):
        r.read(18)
    r.close()


def test_indexed_recordio_native_fast_path(tmp_path):
    path, idx = str(tmp_path / "x.rec"), str(tmp_path / "x.idx")
    w = recordio.MXIndexedRecordIO(idx, path, "w")
    for i in range(8):
        w.write_idx(i * 10, b"rec%d" % i)
    w.close()
    r = recordio.MXIndexedRecordIO(idx, path, "r")
    assert r._native is not None
    assert r.read_idx(30) == b"rec3"
    assert r.read_idx(0) == b"rec0"
    r.close()


def test_indexed_recordio_sorted_idx(tmp_path):
    rec, idx = str(tmp_path / "x.rec"), str(tmp_path / "x.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    payloads = {9: b"nine_payload", 3: b"three_pay", 7: b"seven_p"}
    for k in [9, 3, 7]:  # written out of key order
        w.write_idx(k, payloads[k])
    w.close()
    lines = sorted(open(idx).read().splitlines(), key=lambda l: int(l.split("\t")[0]))
    with open(idx, "w") as f:
        f.write("\n".join(lines) + "\n")
    r = recordio.MXIndexedRecordIO(idx, rec, "r")
    for k, v in payloads.items():
        assert r.read_idx(k) == v
    r.close()
    assert r._native is None  # close() released the native reader


def test_csv_parse(tmp_path):
    path = str(tmp_path / "d.csv")
    data = np.random.RandomState(4).rand(50, 7).astype("f")
    np.savetxt(path, data, delimiter=",")
    vals = native.csv_read_floats(path, 50 * 7 + 10)
    np.testing.assert_allclose(vals.reshape(50, 7), data, rtol=1e-6)


def test_mnist_native_header(tmp_path):
    path = str(tmp_path / "images-idx3-ubyte")
    imgs = (np.arange(2 * 4 * 4) % 256).astype(np.uint8).reshape(2, 4, 4)
    with open(path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 2, 4, 4))
        f.write(imgs.tobytes())
    lib = native.get_lib()
    dims = (ctypes.c_int64 * 4)()
    nd_ = ctypes.c_int()
    assert lib.mnist_read_header(path.encode(), dims, ctypes.byref(nd_)) == 0
    assert nd_.value == 3 and list(dims)[:3] == [2, 4, 4]
    np.testing.assert_array_equal(native.mnist_read(path), imgs)


def test_native_engine_rejects_duplicate_vars():
    eng = native.NativeEngine(num_workers=2)
    v = eng.new_variable()
    with pytest.raises(MXNetError):
        eng.push(lambda: None, const_vars=[v], mutable_vars=[v])
    eng.wait_for_all()
