"""RecordIO of the PyTorch port (counterpart of ``mxnet_tpu/recordio.py``):
record-packed dataset files.

MXRecordIO / MXIndexedRecordIO readers and writers, IRHeader pack /
unpack, the image helpers and the chunked byte-range access of the
streaming pipeline. The binary format is dmlc recordio (magic 0xced7230a,
4-byte-aligned records, lrecord encoding): .rec and .idx files cross
between this package, the JAX package and the reference's im2rec byte for
byte. Reads fire the ``recordio_read`` fault point and go through the
retry policy. Host code only.
"""
from __future__ import annotations

import collections
import os
import struct

import numpy as np

from .base import MXNetError
from .resilience import fault as _fault
from .resilience import retry as _retry

_MAGIC = 0xCED7230A
_KMAGIC_STRUCT = struct.Struct("<II")


def _encode_lrec(cflag, length):
    return (cflag << 29) | length


def _decode_lrec(data):
    cflag = (data >> 29) & 7
    length = data & ((1 << 29) - 1)
    return cflag, length


class MXRecordIO(object):
    """Sequential RecordIO reader/writer (parity recordio.py:17)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if not self.is_open:
            return
        self.handle.close()
        self.is_open = False

    def __del__(self):
        try:
            self.close()
        except (OSError, ValueError, AttributeError, TypeError, NameError):
            # interpreter teardown: builtins (open) may already be gone
            # (NameError/AttributeError/TypeError) or the fd is already
            # unusable (OSError/ValueError on a closed file); an
            # unflushed idx of a leaked writer is the caller's bug.
            # Anything else (e.g. corruption raised from a close-time
            # flush) propagates.
            pass

    def reset(self):
        if self.writable:
            # reopening with "wb" would silently truncate everything
            # written so far — there is no sane meaning for "rewind" on
            # a streaming writer, so make it an explicit error
            raise MXNetError(
                "%s: reset() on a write-mode MXRecordIO would truncate "
                "the file; close() it and open a reader instead"
                % self.uri)
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        data = _KMAGIC_STRUCT.pack(_MAGIC, _encode_lrec(0, len(buf)))
        self.handle.write(data)
        self.handle.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        start = self.handle.tell()

        def _attempt():
            # A transient read error mid-record must not leave the
            # cursor between fields — rewind so the retry re-reads the
            # whole record.
            self.handle.seek(start)
            _fault.fire("recordio_read", uri=self.uri, offset=start)
            header = self.handle.read(8)
            if not header:
                return None  # clean EOF on a record boundary
            if len(header) < 8:
                raise MXNetError(
                    "%s: truncated record header at offset %d "
                    "(%d of 8 bytes)" % (self.uri, start, len(header)))
            magic, lrec = _KMAGIC_STRUCT.unpack(header)
            if magic != _MAGIC:
                raise MXNetError(
                    "%s: invalid record magic 0x%08x at offset %d"
                    % (self.uri, magic, start))
            _, length = _decode_lrec(lrec)
            buf = self.handle.read(length)
            if len(buf) < length:
                raise MXNetError(
                    "%s: truncated record payload at offset %d "
                    "(%d of %d bytes)" % (self.uri, start, len(buf), length))
            pad = (4 - length % 4) % 4
            if pad and len(self.handle.read(pad)) < pad:
                raise MXNetError(
                    "%s: truncated record padding at offset %d"
                    % (self.uri, start))
            return buf

        return _retry.call(_attempt, name="recordio.read")

    def tell(self):
        return self.handle.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access RecordIO with .idx file (parity recordio.py:87).
    Reads go through the native mmap-indexed reader (src/recordio.cc) when
    available — the equivalent of the reference's dmlc RecordIO fast path."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self._native = None
        self._key_to_ord = {}
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin.readlines():
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)
        if not self.writable:
            try:
                from .native import NativeRecordReader

                self._native = NativeRecordReader(self.uri)
                # The .idx file stores record-START byte offsets; the native
                # reader indexes PAYLOAD offsets (start + 8-byte header).
                # Match through the offsets — never list position: a sorted
                # or subset .idx would otherwise silently return the wrong
                # record.
                ord_by_payload = {
                    self._native.payload_offset(i): i
                    for i in range(len(self._native))
                }
                self._key_to_ord = {}
                for k in self.keys:
                    o = ord_by_payload.get(self.idx[k] + 8)
                    if o is not None:
                        self._key_to_ord[k] = o
            except (ImportError, OSError, MXNetError):
                # The native mmap reader is an optional fast path: a
                # missing extension, an unreadable file, or a format the
                # native indexer rejects all fall back to the pure-python
                # seek+read path. Index corruption surfaces from
                # read()/read_idx() with offset context instead of being
                # masked here.
                self._native = None
                self._key_to_ord = {}

    def close(self):
        if not self.is_open:
            return
        if self._native is not None:
            self._native.close()
            self._native = None
        self._key_to_ord = {}
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        super().close()

    def seek(self, idx):
        assert not self.writable
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        if self._native is not None and idx in self._key_to_ord:
            return self._native.read(self._key_to_ord[idx])
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.keys.append(key)
        self.write(buf)


# ---------------------------------------------------------------------------
# Chunked byte-range access (streaming input pipeline, io_pipeline.py).
#
# A .rec file is a flat sequence of 4-byte-aligned records; any record
# START offset is a valid resume point. Splitting the file into
# byte-range chunks lets hosts read disjoint data (shard by
# (host_rank, num_hosts)) and lets decode workers pull whole chunks
# with one sequential read each — the dmlc-core InputSplit design the
# reference's iter_image_recordio_2.cc builds on.

#: One contiguous run of records: [start, end) byte range, the global
#: ordinal of its first record, and how many records it holds.
RecordChunk = collections.namedtuple(
    "RecordChunk", ["start", "end", "ordinal", "n_records"])


def scan_record_offsets(uri):
    """Byte offset of every record start, by hopping header to header
    (reads 8 bytes per record, never the payloads). The no-.idx
    fallback for :func:`build_chunks`."""
    offsets = []
    size = os.path.getsize(uri)
    with open(uri, "rb") as f:
        pos = 0
        while pos + 8 <= size:
            f.seek(pos)
            header = f.read(8)
            if len(header) < 8:
                break
            magic, lrec = _KMAGIC_STRUCT.unpack(header)
            if magic != _MAGIC:
                raise MXNetError(
                    "%s: invalid record magic 0x%08x at offset %d"
                    % (uri, magic, pos))
            _, length = _decode_lrec(lrec)
            offsets.append(pos)
            pos += 8 + length + (4 - length % 4) % 4
    return offsets


def build_chunks(uri, idx_path=None, chunk_bytes=4 << 20):
    """Split a .rec file into record-aligned byte-range chunks of at
    least ``chunk_bytes`` each (the last one may be smaller). Offsets
    come from the sibling .idx when given (O(records) text parse, no
    data reads); otherwise from a header-hopping scan. Returns a list
    of :class:`RecordChunk` covering every record exactly once, in
    file order — shard it ``chunks[host_rank::num_hosts]`` for
    disjoint per-host reads."""
    offsets = None
    if idx_path and os.path.isfile(idx_path):
        offsets = []
        with open(idx_path) as fin:
            for line in fin:
                line = line.strip()
                if line:
                    offsets.append(int(line.split("\t")[1]))
        # .idx line order follows write order; a sorted/subset idx
        # would misalign ordinals — normalize to file order
        offsets.sort()
    if not offsets:
        offsets = scan_record_offsets(uri)
    if not offsets:
        return []
    size = os.path.getsize(uri)
    chunk_bytes = max(1, int(chunk_bytes))
    chunks = []
    start_i = 0
    for i in range(1, len(offsets) + 1):
        end = offsets[i] if i < len(offsets) else size
        if end - offsets[start_i] >= chunk_bytes or i == len(offsets):
            chunks.append(RecordChunk(
                start=offsets[start_i], end=end, ordinal=start_i,
                n_records=i - start_i))
            start_i = i
    return chunks


def split_chunk(buf, uri="<chunk>", base_offset=0):
    """Split one chunk's raw bytes into record payloads (the in-memory
    analog of sequential :meth:`MXRecordIO.read` calls)."""
    payloads = []
    pos = 0
    n = len(buf)
    while pos + 8 <= n:
        magic, lrec = _KMAGIC_STRUCT.unpack_from(buf, pos)
        if magic != _MAGIC:
            raise MXNetError(
                "%s: invalid record magic 0x%08x at offset %d"
                % (uri, magic, base_offset + pos))
        _, length = _decode_lrec(lrec)
        end = pos + 8 + length
        if end > n:
            raise MXNetError(
                "%s: truncated record payload at offset %d"
                % (uri, base_offset + pos))
        payloads.append(bytes(buf[pos + 8:end]))
        pos = end + (4 - length % 4) % 4
    return payloads


def read_chunk(handle, chunk, uri="<chunk>"):
    """One sequential read of ``chunk``'s byte range through an open
    binary ``handle``, split into record payloads."""
    handle.seek(chunk.start)
    buf = handle.read(chunk.end - chunk.start)
    if len(buf) < chunk.end - chunk.start:
        raise MXNetError(
            "%s: truncated chunk [%d, %d) — file shrank under the reader"
            % (uri, chunk.start, chunk.end))
    payloads = split_chunk(buf, uri=uri, base_offset=chunk.start)
    if len(payloads) != chunk.n_records:
        raise MXNetError(
            "%s: chunk at %d holds %d records, index said %d"
            % (uri, chunk.start, len(payloads), chunk.n_records))
    return payloads


# The user-facing header is a namedtuple exactly like the reference
# (recordio.py IRHeader); the wire layout is flag:uint32 label:float32
# id:uint64 id2:uint64.
IRHeader = collections.namedtuple("HEADER", ["flag", "label", "id", "id2"])
_HDR = struct.Struct("IfQQ")


def pack(header, s):
    """Pack (IRHeader, bytes) into a record payload (parity recordio.py:206)."""
    flag, label, id_, id2 = header
    if isinstance(label, (list, tuple, np.ndarray)) and not np.isscalar(label):
        label = np.asarray(label, dtype=np.float32)
        hdr = _HDR.pack(len(label), 0.0, id_, id2)
        return hdr + label.tobytes() + s
    return _HDR.pack(0, float(label), id_, id2) + s


def unpack(s):
    """Unpack a record payload into (IRHeader, bytes)."""
    flag, label, id_, id2 = _HDR.unpack(s[: _HDR.size])
    s = s[_HDR.size:]
    if flag > 0:
        label = np.frombuffer(s[: flag * 4], dtype=np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def unpack_img(s, iscolor=-1):
    """Unpack a record into (IRHeader, image ndarray) — decodes JPEG/PNG."""
    header, s = unpack(s)
    img = _imdecode_np(s, iscolor)
    return header, img


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array into a record (uses PIL if available)."""
    import io as _io

    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError("pack_img requires PIL") from e
    buf = _io.BytesIO()
    fmt = "JPEG" if img_fmt in (".jpg", ".jpeg") else "PNG"
    Image.fromarray(img).save(buf, format=fmt, quality=quality)
    return pack(header, buf.getvalue())


def _imdecode_np(buf, iscolor=-1):
    """Decode an encoded image to an HWC (or HW when ``iscolor == 0``) uint8
    numpy array: the native JPEG and PNG decoders first (they release the
    GIL), then PIL, then cv2."""
    import io as _io

    from . import native as _native

    gray = iscolor == 0
    img = None
    if len(buf) >= 2 and buf[0] == 0xFF and buf[1] == 0xD8:
        img = _native.imdecode_jpeg(buf, gray=gray)
    elif buf[:8] == b"\x89PNG\r\n\x1a\n":
        img = _native.imdecode_png(buf, gray=gray)
    if img is not None:
        return img
    try:
        from PIL import Image
    except ImportError:
        try:
            import cv2
        except ImportError as e:
            raise MXNetError(
                "image decode: this payload needs PIL or cv2 (the native decoders take "
                "JPEG where libjpeg loads and 8-bit gray/RGB/RGBA non-interlaced PNG), "
                "and neither is installed") from e
        arr = np.frombuffer(buf, dtype=np.uint8)
        img = cv2.imdecode(arr, iscolor)
        if img is None:
            raise MXNetError("image decode: cv2 could not decode the payload")
        return img[:, :, ::-1] if img.ndim == 3 else img
    img = Image.open(_io.BytesIO(buf))
    img = img.convert("L") if gray else img.convert("RGB")
    return np.asarray(img)
