"""The .params container across packages: the port writes the bytes the
JAX package writes (and the reference's, built by hand from its layout,
as tests/test_checkpoint_compat.py builds them), and each package loads
what the other wrote, dtypes and values exact, both directions."""
import struct
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

ENTRIES = [
    ("arg:fc1_weight", np.random.RandomState(0).randn(4, 3).astype(np.float32)),
    ("arg:fc1_bias", np.random.RandomState(1).randn(4).astype(np.float16)),
    ("aux:bn_moving_mean", np.random.RandomState(2).randn(4).astype(np.float64)),
    ("aux:counts", np.random.RandomState(3).randint(0, 9, (2, 2)).astype(np.int32)),
    ("aux:steps", np.arange(3, dtype=np.int64)),
    ("arg:mask", np.array([[0, 255], [7, 1]], np.uint8)),
    ("arg:tiny", np.array([-3, 4], np.int8)),
]


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _reference_params_bytes(entries):
    """A .params file exactly as reference NDArray::Save writes it."""
    code = {"float32": 0, "float64": 1, "float16": 2, "uint8": 3, "int32": 4, "int8": 5,
            "int64": 6}
    out = [struct.pack("<QQ", 0x112, 0), struct.pack("<Q", len(entries))]
    for _name, arr in entries:
        out.append(struct.pack("<I", arr.ndim))
        out.append(struct.pack("<%dI" % arr.ndim, *arr.shape))
        out.append(struct.pack("<ii", 1, 0))
        out.append(struct.pack("<i", code[arr.dtype.name]))
        out.append(np.ascontiguousarray(arr).tobytes())
    out.append(struct.pack("<Q", len(entries)))
    for name, _arr in entries:
        out.append(struct.pack("<Q", len(name.encode())))
        out.append(name.encode())
    return b"".join(out)


def _save(pkg, path, entries):
    pkg.nd.save(str(path), {n: pkg.nd.array(a, dtype=a.dtype) for n, a in entries})
    return path.read_bytes()


def test_port_writes_the_jax_and_reference_bytes(tmp_path):
    ours = _save(tmx, tmp_path / "port.params", ENTRIES)
    assert ours == _save(jmx, tmp_path / "jax.params", ENTRIES)
    assert ours == _reference_params_bytes(ENTRIES)
    assert tmx.nd.save_buffer([tmx.nd.array(ENTRIES[0][1])]) == \
        jmx.nd.save_buffer([jmx.nd.array(ENTRIES[0][1])])


@pytest.mark.parametrize("writer,reader", [(jmx, tmx), (tmx, jmx)], ids=["jax->port", "port->jax"])
def test_files_cross_packages(tmp_path, writer, reader):
    path = tmp_path / "x.params"
    _save(writer, path, ENTRIES)
    loaded = reader.nd.load(str(path))
    assert list(loaded) == [n for n, _ in ENTRIES]
    for name, arr in ENTRIES:
        got = loaded[name].asnumpy()
        assert got.dtype == arr.dtype, name
        np.testing.assert_array_equal(got, arr)
    lst = [writer.nd.array(a, dtype=a.dtype) for _, a in ENTRIES[:2]]
    writer.nd.save(str(path), lst)
    back = reader.nd.load(str(path))
    assert isinstance(back, list) and len(back) == 2
    np.testing.assert_array_equal(back[1].asnumpy(), ENTRIES[1][1])


def test_bfloat16_crosses_with_the_extension_code(tmp_path):
    """bfloat16 (code 12, the JAX package's extension) round-trips both
    ways with a warning that reference MXNet cannot read it."""
    v = np.array([1.0, -2.5, 3.140625], np.float32)
    for writer, reader in ((tmx, jmx), (jmx, tmx)):
        path = tmp_path / "bf16.params"
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            writer.nd.save(str(path), {"w": writer.nd.array(v, dtype="bfloat16")})
        assert any("extension code 12" in str(w.message) for w in caught)
        got = reader.nd.load(str(path))["w"]
        np.testing.assert_array_equal(np.asarray(got.asnumpy(), np.float32), v)
    assert _save(tmx, tmp_path / "a", [("w", v)]) == _save(jmx, tmp_path / "b", [("w", v)])


def test_load_reference_and_legacy_containers(tmp_path):
    path = tmp_path / "ref.params"
    path.write_bytes(_reference_params_bytes(ENTRIES[:4]))
    loaded = tmx.nd.load(str(path))
    for name, arr in ENTRIES[:4]:
        np.testing.assert_array_equal(loaded[name].asnumpy(), arr)
    arr = np.arange(4, dtype=np.float32).reshape(2, 2)
    buf = [b"MXTPU001", struct.pack("<qq", 1, 1), struct.pack("<q", 5), b"arg:w",
           struct.pack("<q", 0), struct.pack("<q", 2), struct.pack("<2q", 2, 2), arr.tobytes()]
    path.write_bytes(b"".join(buf))
    np.testing.assert_array_equal(tmx.nd.load(str(path))["arg:w"].asnumpy(), arr)
    path.write_bytes(b"not a params file")
    with pytest.raises(tmx.MXNetError, match="invalid"):
        tmx.nd.load(str(path))
