"""RecordIO of the PyTorch port (``mxnet_tpu_torch/recordio.py``) on the CPU,
held to the JAX package (``mxnet_tpu/recordio.py``).

The recordio cases of ``tests/test_io.py`` (round trip, a write-mode
reset refused, the indexed reader, pack / unpack) and of
``tests/test_resilience.py`` (clean EOF, truncated payload / header and a
bad magic with their offsets, a transient read absorbed by the retry) run
on the port. Across the packages: the same records written by both
writers give the same .rec and .idx bytes, and each package reads the
other's files record for record (plain, indexed, chunked); ``pack`` and
``pack_img`` give the same bytes; the chunk splitter gives the same
chunks. Everything here is exact (bytes and integers)."""
import os

import numpy as np
import pytest

from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import fault


def _payloads(seed=0, n=13):
    rng = np.random.RandomState(seed)
    return [rng.bytes(int(rng.randint(0, 300))) for _ in range(n)]


def _write(mod, path, payloads, idx=None):
    w = mod.MXIndexedRecordIO(idx, path, "w") if idx else mod.MXRecordIO(path, "w")
    for i, p in enumerate(payloads):
        if idx:
            w.write_idx(i * 3, p)
        else:
            w.write(p)
    w.close()


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------

def test_recordio_roundtrip(tmp_path):
    path = str(tmp_path / "test.rec")
    writer = recordio.MXRecordIO(path, "w")
    for i in range(5):
        writer.write(b"record%d" % i)
    writer.close()
    reader = recordio.MXRecordIO(path, "r")
    for i in range(5):
        assert reader.read() == b"record%d" % i
    assert reader.read() is None
    reader.close()


def test_recordio_writer_reset_refuses_truncation(tmp_path):
    path = str(tmp_path / "test.rec")
    writer = recordio.MXRecordIO(path, "w")
    for i in range(3):
        writer.write(b"keep%d" % i)
    with pytest.raises(MXNetError, match="truncate"):
        writer.reset()
    writer.close()
    reader = recordio.MXRecordIO(path, "r")
    assert [reader.read() for _ in range(3)] == [b"keep0", b"keep1", b"keep2"]
    reader.reset()  # read-mode reset still rewinds
    assert reader.read() == b"keep0"
    reader.close()


def test_indexed_recordio(tmp_path):
    path, idx_path = str(tmp_path / "test.rec"), str(tmp_path / "test.idx")
    writer = recordio.MXIndexedRecordIO(idx_path, path, "w")
    for i in range(5):
        writer.write_idx(i, b"rec%d" % i)
    writer.close()
    reader = recordio.MXIndexedRecordIO(idx_path, path, "r")
    assert reader.read_idx(3) == b"rec3"
    assert reader.read_idx(0) == b"rec0"
    reader.close()


def test_pack_unpack_matches_jax():
    payload = b"imagebytes"
    for hdr in [(0, 3.5, 7, 0), (0, [1.0, 2.0, 3.0], 7, 0), (0, np.arange(5.0), 2, 9)]:
        s = recordio.pack(hdr, payload)
        assert s == jrec.pack(hdr, payload)
        header, data = recordio.unpack(s)
        jheader, jdata = jrec.unpack(s)
        assert data == jdata == payload
        np.testing.assert_array_equal(np.asarray(header.label), np.asarray(jheader.label))
        assert header[0] == jheader[0] and header[2:] == jheader[2:]


def test_pack_img_matches_jax():
    pytest.importorskip("PIL")
    rng = np.random.RandomState(1)
    img = rng.randint(0, 255, (12, 17, 3)).astype(np.uint8)
    hdr = recordio.IRHeader(0, 4.0, 3, 0)
    for fmt in (".jpg", ".png"):
        assert recordio.pack_img(hdr, img, img_fmt=fmt) == jrec.pack_img(hdr, img, img_fmt=fmt)
    _, png = recordio.unpack_img(recordio.pack_img(hdr, img, img_fmt=".png"))
    np.testing.assert_array_equal(png, img)


def _write_rec(path, payloads):
    rec = recordio.MXRecordIO(path, "w")
    for p in payloads:
        rec.write(p)
    rec.close()


def test_recordio_truncated_payload_has_offset_context(tmp_path):
    path = str(tmp_path / "torn.rec")
    _write_rec(path, [b"hello", b"worldworld"])
    with open(path, "r+b") as f:
        f.truncate(26)  # inside the second record's payload
    rec = recordio.MXRecordIO(path, "r")
    assert rec.read() == b"hello"
    with pytest.raises(MXNetError) as exc:
        rec.read()
    msg = str(exc.value)
    assert "truncated record payload" in msg and "offset 16" in msg and path in msg
    rec.close()


def test_recordio_truncated_header_and_bad_magic(tmp_path):
    path = str(tmp_path / "head.rec")
    _write_rec(path, [b"hello", b"worldworld"])
    with open(path, "r+b") as f:
        f.truncate(20)
    rec = recordio.MXRecordIO(path, "r")
    assert rec.read() == b"hello"
    with pytest.raises(MXNetError, match="truncated record header"):
        rec.read()
    rec.close()
    bad = str(tmp_path / "magic.rec")
    _write_rec(bad, [b"hello"])
    with open(bad, "r+b") as f:
        f.write(b"\xde\xad\xbe\xef")
    rec = recordio.MXRecordIO(bad, "r")
    with pytest.raises(MXNetError) as exc:
        rec.read()
    assert "invalid record magic" in str(exc.value) and "offset 0" in str(exc.value)
    rec.close()


def test_recordio_transient_read_retried(tmp_path, monkeypatch):
    path = str(tmp_path / "flaky.rec")
    _write_rec(path, [b"hello", b"again"])
    monkeypatch.setenv(fault.ENV, "fail_recordio_read=2,unit=recordio_test")
    rec = recordio.MXRecordIO(path, "r")
    assert rec.read() == b"hello"  # two injected EIOs absorbed by the retry
    assert rec.read() == b"again"
    rec.close()


def test_recordio_read_failures_past_the_retry_budget_raise(tmp_path, monkeypatch):
    path = str(tmp_path / "flaky.rec")
    _write_rec(path, [b"hello"])
    monkeypatch.setenv(fault.ENV, "fail_recordio_read=50,unit=recordio_budget")
    monkeypatch.setenv("MXTPU_RETRY_MAX", "2")
    rec = recordio.MXRecordIO(path, "r")
    with pytest.raises(OSError, match="injected transient fault"):
        rec.read()
    rec.close()


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("indexed", [False, True])
def test_writers_give_the_same_bytes(tmp_path, indexed):
    payloads = _payloads()
    for mod, name in ((recordio, "port"), (jrec, "jax")):
        _write(mod, str(tmp_path / (name + ".rec")), payloads,
               str(tmp_path / (name + ".idx")) if indexed else None)
    for ext in (".rec",) + ((".idx",) if indexed else ()):
        with open(tmp_path / ("port" + ext), "rb") as a, open(tmp_path / ("jax" + ext), "rb") as b:
            assert a.read() == b.read(), ext


@pytest.mark.parametrize("writer,reader", [(jrec, recordio), (recordio, jrec)],
                         ids=["jax_to_port", "port_to_jax"])
def test_files_cross_both_ways(tmp_path, writer, reader):
    payloads = _payloads(seed=3, n=21)
    rec, idx = str(tmp_path / "x.rec"), str(tmp_path / "x.idx")
    _write(writer, rec, payloads, idx)
    seq = reader.MXRecordIO(rec, "r")
    assert [seq.read() for _ in payloads] == payloads and seq.read() is None
    seq.close()
    ind = reader.MXIndexedRecordIO(idx, rec, "r")
    assert ind.keys == [i * 3 for i in range(len(payloads))]
    for i in reversed(range(len(payloads))):
        assert ind.read_idx(i * 3) == payloads[i]
    ind.close()


def test_chunks_match_jax(tmp_path):
    payloads = _payloads(seed=5, n=40)
    rec, idx = str(tmp_path / "c.rec"), str(tmp_path / "c.idx")
    _write(recordio, rec, payloads, idx)
    for chunk_bytes in (1, 500, 4096, 1 << 20):
        got = recordio.build_chunks(rec, idx, chunk_bytes)
        assert [tuple(c) for c in got] == [tuple(c) for c in jrec.build_chunks(rec, idx,
                                                                           chunk_bytes)]
        assert got == recordio.build_chunks(rec, None, chunk_bytes)  # the header scan
        with open(rec, "rb") as f:
            flat = [p for c in got for p in recordio.read_chunk(f, c, uri=rec)]
        assert flat == payloads
    assert recordio.scan_record_offsets(rec) == jrec.scan_record_offsets(rec)


def test_chunk_errors_name_the_offset(tmp_path):
    rec = str(tmp_path / "e.rec")
    _write_rec(rec, [b"abc", b"defgh"])
    chunk = recordio.build_chunks(rec, None, 1)[1]
    with open(rec, "rb") as f:
        buf = bytearray(f.read())
    buf[chunk.start:chunk.start + 4] = b"\0\0\0\0"
    with pytest.raises(MXNetError, match="invalid record magic 0x00000000 at offset %d"
                       % chunk.start):
        recordio.split_chunk(bytes(buf[chunk.start:chunk.end]), uri=rec,
                             base_offset=chunk.start)
    with open(rec, "rb") as f:
        with pytest.raises(MXNetError, match="index said 3"):
            recordio.read_chunk(f, chunk._replace(n_records=3), uri=rec)
    os.truncate(rec, chunk.end - 2)
    with open(rec, "rb") as f:
        with pytest.raises(MXNetError, match="truncated chunk"):
            recordio.read_chunk(f, chunk, uri=rec)
