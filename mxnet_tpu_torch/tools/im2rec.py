"""im2rec of the PyTorch port (counterpart of ``tools/im2rec.py``, the
reference's tools/im2rec.py): pack an image dataset into RecordIO files.

    python -m mxnet_tpu_torch.tools.im2rec --list prefix image_root   # prefix.lst
    python -m mxnet_tpu_torch.tools.im2rec prefix image_root          # prefix.rec/.idx

An image directory (label = the folder's index) or a prepared ``.lst`` of
``index\\tlabel(s)\\tpath`` lines becomes ``prefix.rec`` + ``prefix.idx``,
the files ``ImageRecordIter`` streams (and the JAX package reads byte for
byte). Images are loaded, resized (``--resize``: the shorter edge) and
re-encoded (``--encoding`` .jpg or .png) by a pool of processes with PIL,
or cv2 where PIL is missing; with neither it raises. Records are written
by one writer in index order, so the files are deterministic.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .. import recordio
from ..base import MXNetError

_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def make_list(prefix, root, recursive=True, train_ratio=1.0, shuffle=True, seed=0):
    """Walk ``root`` and write ``prefix.lst`` (label = the folder's index)."""
    entries = []
    classes = {}
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        if not recursive and dirpath != root:
            continue
        for fname in sorted(filenames):
            if fname.lower().endswith(_EXTS):
                rel = os.path.relpath(os.path.join(dirpath, fname), root)
                cls = os.path.dirname(rel) or "."
                label = classes.setdefault(cls, len(classes))
                entries.append((label, rel))
    if shuffle:
        np.random.RandomState(seed).shuffle(entries)
    n_train = int(len(entries) * train_ratio)
    out = "%s.lst" % prefix
    with open(out, "w") as f:
        for i, (label, rel) in enumerate(entries[:n_train]):
            f.write("%d\t%f\t%s\n" % (i, float(label), rel))
    if train_ratio < 1.0:
        with open("%s_val.lst" % prefix, "w") as f:
            for i, (label, rel) in enumerate(entries[n_train:]):
                f.write("%d\t%f\t%s\n" % (i, float(label), rel))
    return out, classes


def read_list(lst_path):
    with open(lst_path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            yield int(parts[0]), [float(x) for x in parts[1:-1]], parts[-1]


def codec():
    """"PIL" or "cv2", whichever imports first; raises without either."""
    for name in ("PIL", "cv2"):
        try:
            __import__(name)
            return name
        except ImportError:
            pass
    raise MXNetError("im2rec needs PIL or cv2 to load and encode images; neither is installed")


def _load(path, color, resize):
    """An image file as an HWC (HW for ``color`` 0) uint8 RGB array,
    its shorter edge resized to ``resize`` when given."""
    if codec() == "PIL":
        from PIL import Image

        img = Image.open(path).convert("L" if color == 0 else "RGB")
        if resize:
            w, h = img.size
            scale = resize / float(min(w, h))
            img = img.resize((max(1, int(w * scale)), max(1, int(h * scale))))
        return np.asarray(img)
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if color == 0 else cv2.IMREAD_COLOR)
    if img is None:
        raise MXNetError("cv2 cannot read %s" % path)
    if resize:
        h, w = img.shape[:2]
        scale = resize / float(min(w, h))
        img = cv2.resize(img, (max(1, int(w * scale)), max(1, int(h * scale))))
    return img if img.ndim == 2 else img[:, :, ::-1]


def _encode(arr, quality, img_fmt):
    if codec() == "PIL":
        return None  # recordio.pack_img encodes with PIL
    import cv2

    bgr = arr if arr.ndim == 2 else arr[:, :, ::-1]
    params = [cv2.IMWRITE_JPEG_QUALITY, quality] if img_fmt == ".jpg" else []
    ok, buf = cv2.imencode(img_fmt, bgr, params)
    if not ok:
        raise MXNetError("cv2 cannot encode %s" % img_fmt)
    return buf.tobytes()


def _process_image(args):
    """Worker: load, resize, encode, pack one record; (idx, None) for an
    unreadable image (skipped, as the reference does)."""
    idx, labels, path, root, resize, quality, color, img_fmt = args
    try:
        arr = _load(os.path.join(root, path), color, resize)
        label = labels[0] if len(labels) == 1 else np.asarray(labels, np.float32)
        header = recordio.IRHeader(0, label, idx, 0)
        encoded = _encode(arr, quality, img_fmt)
        if encoded is None:
            return idx, recordio.pack_img(header, arr, quality=quality, img_fmt=img_fmt)
        return idx, recordio.pack(header, encoded)
    except (OSError, ValueError, MXNetError) as e:
        print("im2rec: skipping %s (%s)" % (path, e), file=sys.stderr)
        return idx, None


def pack(prefix, root, num_workers=4, resize=0, quality=95, color=1, img_fmt=".jpg"):
    """Pack ``prefix.lst`` into ``prefix.rec`` + ``prefix.idx``; returns the
    number of records written."""
    import multiprocessing as mp

    codec()  # fail before any work without an encoder
    items = [(idx, labels, path, root, resize, quality, color, img_fmt)
             for idx, labels, path in read_list("%s.lst" % prefix)]
    writer = recordio.MXIndexedRecordIO("%s.idx" % prefix, "%s.rec" % prefix, "w")
    n = 0
    if num_workers > 1:
        with mp.get_context("spawn").Pool(num_workers) as pool:
            results = list(pool.imap(_process_image, items, chunksize=16))
    else:
        results = [_process_image(item) for item in items]
    for idx, payload in results:
        if payload is not None:
            writer.write_idx(idx, payload)
            n += 1
    writer.close()
    print("im2rec: packed %d records into %s.rec" % (n, prefix))
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("prefix", help="prefix of the .lst/.rec/.idx files")
    p.add_argument("root", help="image root directory")
    p.add_argument("--list", action="store_true", help="make the .lst file instead of packing")
    p.add_argument("--no-recursive", action="store_true",
                   help="only the images directly under the root")
    p.add_argument("--train-ratio", type=float, default=1.0)
    p.add_argument("--no-shuffle", action="store_true")
    p.add_argument("--resize", type=int, default=0, help="resize the shorter edge to this")
    p.add_argument("--quality", type=int, default=95)
    p.add_argument("--encoding", default=".jpg", choices=[".jpg", ".png"])
    p.add_argument("--color", type=int, default=1, choices=[0, 1])
    p.add_argument("--num-thread", type=int, default=4)
    args = p.parse_args(argv)
    if args.list:
        out, classes = make_list(args.prefix, args.root, recursive=not args.no_recursive,
                                 train_ratio=args.train_ratio, shuffle=not args.no_shuffle)
        print("im2rec: wrote %s (%d classes)" % (out, len(classes)))
    else:
        pack(args.prefix, args.root, num_workers=args.num_thread, resize=args.resize,
             quality=args.quality, color=args.color, img_fmt=args.encoding)


if __name__ == "__main__":
    main()
