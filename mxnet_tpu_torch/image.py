"""Image pipeline of the PyTorch port (counterpart of ``mxnet_tpu/image.py``):
``imdecode``, the augmenters, ``CreateAugmenter``, ``ImageIter`` (records
or an image list, decoded and augmented on a thread pool) with
``from_recordio_params`` (the C++ ImageRecordIter's parameter names), and
the detection iterators ``ImageDetIter`` / ``DetRecordIter``.

Decode and augmentation are host work: they run on numpy arrays and never
touch CUDA. An augmenter given an NDArray returns an NDArray on that
array's context; given a numpy array (as ``ImageIter`` gives it) it
returns numpy. The random crops and flips draw from ``random`` and
``np.random`` in the JAX package's order, so one seed gives the same crops
in both packages. ``imresize`` is ``jax.image.resize(..., "bilinear")``
written out: a triangle kernel, widened by the scale when shrinking
(antialiased), applied along each axis whose size changes.
"""
from __future__ import annotations

import logging
import os
import random

import numpy as np
import torch

from . import ndarray as nd
from . import recordio
from .base import MXNetError
from .io import DataBatch, DataDesc, DataIter


def _host(src):
    return src.asnumpy() if isinstance(src, nd.NDArray) else np.asarray(src)


def _like(out, src):
    """``out`` (numpy) as the caller's type: an NDArray on ``src``'s context
    when ``src`` was one."""
    if isinstance(src, nd.NDArray):
        return nd.array(out, ctx=src.context, dtype=out.dtype)
    return out


def imdecode(buf, **kwargs):
    """Decode an image byte buffer to an NDArray (HWC, RGB, float32) on the
    current context."""
    arr = recordio._imdecode_np(buf if isinstance(buf, bytes) else bytes(buf),
                                kwargs.get("flag", 1))
    return nd.array(arr.astype(np.float32))


def scale_down(src_size, size):
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    if isinstance(src, nd.NDArray):
        return imresize(src, new_w, new_h, interp=interp)
    return _resize_np(src, new_w, new_h)


def _resize_weights(n_in, n_out):
    """JAX's ``compute_weight_mat`` for the triangle kernel, translation 0,
    antialiased, in float64: (n_in, n_out)."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float64)[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_np(src, w, h):
    """The numpy form of :func:`imresize`."""
    x = torch.from_numpy(np.ascontiguousarray(src))
    if not x.is_floating_point():
        x = x.to(torch.float32)
    for axis, n_out in ((0, h), (1, w)):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        wm = _resize_weights(n_in, n_out).to(x.dtype)
        x = torch.tensordot(x.movedim(axis, -1), wm, dims=1).movedim(-1, axis)
    return x.contiguous().numpy()


def imresize(src, w, h, interp=2):
    """Bilinear resize to (h, w) as ``jax.image.resize(..., "bilinear")``:
    float out (integer images become float32), antialiased when shrinking;
    an NDArray on ``src``'s context (the current one for numpy input)."""
    out = _resize_np(_host(src), w, h)
    return nd.array(out, ctx=src.context if isinstance(src, nd.NDArray) else None,
                    dtype=out.dtype)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        if isinstance(src, nd.NDArray):
            out = imresize(out, size[0], size[1], interp=interp)
        else:
            out = _resize_np(out, size[0], size[1])
    return out


def random_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = scale_down((w, h), size)
    x0 = random.randint(0, w - new_w)
    y0 = random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    src = src - mean
    if std is not None:
        src = src / std
    return src


def random_size_crop(src, size, min_area=0.08, ratio=(3.0 / 4.0, 4.0 / 3.0), interp=2):
    h, w = src.shape[0], src.shape[1]
    area = w * h
    for _ in range(10):
        new_area = random.uniform(min_area, 1.0) * area
        new_ratio = random.uniform(*ratio)
        new_w = int(np.sqrt(new_area * new_ratio))
        new_h = int(np.sqrt(new_area / new_ratio))
        if random.random() < 0.5:
            new_w, new_h = new_h, new_w
        if new_w <= w and new_h <= h:
            x0 = random.randint(0, w - new_w)
            y0 = random.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def ResizeAug(size, interp=2):
    def aug(src):
        return [resize_short(src, size, interp)]

    return aug


def RandomCropAug(size, interp=2):
    def aug(src):
        return [random_crop(src, size, interp)[0]]

    return aug


def RandomSizedCropAug(size, min_area, ratio, interp=2):
    def aug(src):
        return [random_size_crop(src, size, min_area, ratio, interp)[0]]

    return aug


def CenterCropAug(size, interp=2):
    def aug(src):
        return [center_crop(src, size, interp)[0]]

    return aug


def RandomOrderAug(ts):
    def aug(src):
        srcs = [src]
        # shuffle a per-call copy: augmenters run on a thread pool, and
        # concurrent in-place shuffles of the shared list would corrupt it
        order = list(ts)
        random.shuffle(order)
        for t in order:
            srcs = sum([t(s) for s in srcs], [])
        return srcs

    return aug


_GRAY_COEF = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)


def ColorJitterAug(brightness, contrast, saturation):
    ts = []
    if brightness > 0:

        def baug(src):
            alpha = 1.0 + random.uniform(-brightness, brightness)
            return [_like(_host(src) * np.float32(alpha), src)]

        ts.append(baug)
    if contrast > 0:

        def caug(src):
            alpha = 1.0 + random.uniform(-contrast, contrast)
            x = _host(src)
            gray = x * _GRAY_COEF
            gray = np.float32(3.0 * (1.0 - alpha) / gray.size) * gray.sum(dtype=np.float32)
            return [_like(x * np.float32(alpha) + gray, src)]

        ts.append(caug)
    if saturation > 0:

        def saug(src):
            alpha = 1.0 + random.uniform(-saturation, saturation)
            x = _host(src)
            gray = (x * _GRAY_COEF).sum(axis=2, keepdims=True, dtype=np.float32)
            return [_like(x * np.float32(alpha) + gray * np.float32(1.0 - alpha), src)]

        ts.append(saug)
    return RandomOrderAug(ts)


def LightingAug(alphastd, eigval, eigvec):
    def aug(src):
        alpha = np.random.normal(0, alphastd, size=(3,))
        rgb = np.dot(eigvec * alpha, eigval).astype(np.float32)
        return [_like(_host(src) + rgb, src)]

    return aug


def ColorNormalizeAug(mean, std):
    mean = None if mean is None else np.asarray(_host(mean), np.float32)
    std = None if std is None else np.asarray(_host(std), np.float32)

    def aug(src):
        return [_like(color_normalize(_host(src), mean, std), src)]

    return aug


def HorizontalFlipAug(p):
    def aug(src):
        if random.random() < p:
            return [_like(np.ascontiguousarray(_host(src)[:, ::-1]), src)]
        return [src]

    return aug


def CastAug():
    def aug(src):
        return [src.astype(np.float32)]

    return aug


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0, contrast=0,
                    saturation=0, pca_noise=0, inter_method=2):
    """The reference's default augmenter list (image.py:351)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, 0.3, (3.0 / 4.0, 4.0 / 3.0), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    elif mean is not None:
        assert isinstance(mean, np.ndarray) and mean.shape[0] in [1, 3]
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    elif std is not None:
        assert isinstance(std, np.ndarray) and std.shape[0] in [1, 3]
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(DataIter):
    """Image iterator over .rec (RecordIO) or .lst + images: decode and
    augmentation on ``preprocess_threads`` host threads, batches NCHW
    float32 made with ``nd.array`` on the current context (enter
    ``mx.cpu()``, as ``DeviceFeedIter`` does, for host batches)."""

    def __init__(self, batch_size, data_shape, label_width=1, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None, shuffle=False,
                 part_index=0, num_parts=1, aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", preprocess_threads=4, **kwargs):
        super().__init__()
        assert path_imgrec or path_imglist or (isinstance(imglist, list))
        if path_imgrec:
            logging.info("loading recordio %s...", path_imgrec)
            if path_imgidx:
                self.imgrec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
                self.imgidx = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
                self.imgidx = None
        else:
            self.imgrec = None
        if path_imglist:
            logging.info("loading image list %s...", path_imglist)
            with open(path_imglist) as fin:
                imglist = {}
                imgkeys = []
                for line in iter(fin.readline, ""):
                    line = line.strip().split("\t")
                    label = np.array([float(i) for i in line[1:-1]])
                    key = int(line[0])
                    imglist[key] = (label, line[-1])
                    imgkeys.append(key)
                self.imglist = imglist
        elif isinstance(imglist, list):
            logging.info("loading image list...")
            result = {}
            imgkeys = []
            index = 1
            for img in imglist:
                key = str(index)
                index += 1
                if isinstance(img[0], (list, np.ndarray)):
                    label = np.array(img[0])
                else:
                    label = np.array([img[0]])
                result[key] = (label, img[1])
                imgkeys.append(str(key))
            self.imglist = result
        else:
            self.imglist = None
        self.path_root = path_root

        self.check_data_shape(data_shape)
        self.provide_data = [DataDesc(data_name, (batch_size,) + data_shape)]
        if label_width > 1:
            self.provide_label = [DataDesc(label_name, (batch_size, label_width))]
        else:
            self.provide_label = [DataDesc(label_name, (batch_size,))]
        self.batch_size = batch_size
        self.data_shape = data_shape
        self.label_width = label_width
        self.shuffle = shuffle
        self.preprocess_threads = int(preprocess_threads)
        self._pool = None
        self._fanout = None  # outputs per input, learned from the first sample
        if self.imgrec is None:
            self.seq = imgkeys
        elif shuffle or num_parts > 1:
            assert self.imgidx is not None, "shuffling/partition requires a .idx file"
            self.seq = self.imgidx
        else:
            self.seq = None
        if num_parts > 1 and self.seq is not None:
            assert part_index < num_parts
            n = len(self.seq)
            c = n // num_parts
            self.seq = self.seq[part_index * c:(part_index + 1) * c]
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ("resize", "rand_crop", "rand_resize", "rand_mirror", "mean", "std",
                         "brightness", "contrast", "saturation", "pca_noise", "inter_method")})
        else:
            self.auglist = aug_list
        self.cur = 0
        self.reset()

    @classmethod
    def from_recordio_params(cls, path_imgrec, data_shape, batch_size, mean_r=0.0, mean_g=0.0,
                             mean_b=0.0, scale=1.0, rand_crop=False, rand_mirror=False,
                             shuffle=False, preprocess_threads=4, path_imgidx=None,
                             label_width=1, input_workers=None, seed=0, shuffle_buffer=None,
                             strict_order=None, **kwargs):
        """The C++ ImageRecordIter's parameter names. With ``input_workers``
        (or ``MXTPU_INPUT_WORKERS``) > 0 this returns the chunk-sharded,
        process-parallel :class:`io_pipeline.StreamingImageRecordIter`
        (its augmenters are rebuilt in each worker from a declarative
        recipe); else the thread-pool ImageIter."""
        from . import io_pipeline

        mean = None
        if mean_r or mean_g or mean_b:
            mean = np.array([mean_r, mean_g, mean_b])
        if path_imgidx is None and path_imgrec.endswith(".rec"):
            # im2rec writes the sibling .idx: shuffle / partition need it
            candidate = path_imgrec[:-4] + ".idx"
            if os.path.exists(candidate):
                path_imgidx = candidate
        if input_workers is None:
            input_workers = io_pipeline.input_workers()
        if input_workers > 0:
            recipe = {"rand_crop": rand_crop, "rand_mirror": rand_mirror, "scale": scale}
            if mean is not None:
                recipe["mean"] = mean
            return io_pipeline.StreamingImageRecordIter(
                batch_size, tuple(data_shape), path_imgrec, path_imgidx=path_imgidx,
                label_width=label_width, shuffle=shuffle, seed=seed, aug_recipe=recipe,
                workers=input_workers, shuffle_buffer=shuffle_buffer,
                strict_order=strict_order)
        aug = CreateAugmenter(data_shape, rand_crop=rand_crop, rand_mirror=rand_mirror, mean=mean)
        if scale != 1.0:
            aug.append(lambda src: [src * scale])
        return cls(batch_size, tuple(data_shape), label_width=label_width,
                   path_imgrec=path_imgrec, path_imgidx=path_imgidx, shuffle=shuffle,
                   aug_list=aug, preprocess_threads=preprocess_threads)

    def reset(self):
        if self.shuffle and self.seq is not None:
            random.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                if self.imglist is None:
                    return header.label, img
                return self.imglist[idx][0], img
            label, fname = self.imglist[idx]
            return label, self.read_image(fname)
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def _decode_augment(self, s):
        """One sample's decode and augment chain, on a worker thread; numpy
        end to end (the batch moves once, after assembly). Returns a list
        of HWC float arrays (augmenters may fan out)."""
        if isinstance(s, (bytes, bytearray)):
            arr = recordio._imdecode_np(bytes(s), 1).astype(np.float32)
        else:
            arr = np.asarray(s, np.float32)
        if arr.shape[0] == 0:
            return []
        data = [arr]
        for aug in self.auglist:
            data = [ret for src in data for ret in aug(src)]
        return [_host(d) for d in data]

    def _workers(self):
        if self._pool is None and self.preprocess_threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.preprocess_threads)
        return self._pool

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = np.zeros((batch_size, c, h, w), dtype=np.float32)
        batch_label = np.zeros(
            (batch_size,) if self.label_width == 1 else (batch_size, self.label_width),
            dtype=np.float32)
        pool = self._workers()
        i = 0
        exhausted = False
        while i < batch_size and not exhausted:
            # probe one sample until the augmenters' fan-out is known, then
            # pull as many samples as the remaining slots need
            fanout = self._fanout or 1
            need = 1 if self._fanout is None else max(1, (batch_size - i) // fanout)
            samples = []
            try:
                while len(samples) < need:
                    samples.append(self.next_sample())
            except StopIteration:
                exhausted = True
                if not samples:
                    break
            if pool is not None and len(samples) > 1:
                decoded = list(pool.map(self._decode_augment, [s for _l, s in samples]))
            else:
                decoded = [self._decode_augment(s) for _l, s in samples]
            for (label, _s), imgs in zip(samples, decoded):
                if not imgs:
                    logging.debug("Invalid image, skipping.")
                    continue
                if self._fanout is None:
                    self._fanout = len(imgs)
                assert i + len(imgs) <= batch_size, \
                    "Batch size must be multiple of augmenter output length"
                for d in imgs:
                    batch_data[i] = d.transpose(2, 0, 1) if d.ndim == 3 else d
                    batch_label[i] = label
                    i += 1
        if i == 0:
            raise StopIteration
        from .io_pipeline import _batch_array

        return DataBatch([_batch_array(batch_data)], [_batch_array(batch_label)],
                         batch_size - i)

    def check_data_shape(self, data_shape):
        if not len(data_shape) == 3:
            raise ValueError("data_shape should have length 3, with dimensions CxHxW")
        if not data_shape[0] == 3 and not data_shape[0] == 1:
            raise ValueError("This iterator expects inputs to have 1 or 3 channels.")

    def read_image(self, fname):
        with open(os.path.join(self.path_root or "", fname), "rb") as fin:
            return fin.read()


class ImageDetIter(DataIter):
    """Detection RecordIO iterator (the C++ iter_image_det_recordio.cc).

    Records packed by im2rec from detection .lst files (label = [header
    width, object width, (id, xmin, ymin, xmax, ymax, ...)...], normalized
    corners) come out with the C++ iterator's label contract per image:
    ``[c, h, w, len, packed..., pad]``; the width is 4 + label_pad_width,
    the dataset's widest label when label_pad_width <= 0. rand_mirror flips
    the image and its boxes' x. Resizing uses PIL, which this iterator
    needs.
    """

    def __init__(self, batch_size, data_shape, path_imgrec, path_imgidx=None, shuffle=False,
                 label_pad_width=-1, label_pad_value=-1.0, rand_mirror=False,
                 mean_pixels=None, scale=1.0, data_name="data", label_name="label", **kwargs):
        super().__init__()
        if kwargs:
            # a misspelled or unported C++ parameter would silently change training
            raise TypeError("ImageDetIter: unsupported parameters %s" % sorted(kwargs))
        self.batch_size = batch_size
        self.check_data_shape(data_shape)
        self.data_shape = data_shape
        self.label_pad_value = float(label_pad_value)
        self.rand_mirror = rand_mirror
        self.mean_pixels = (np.asarray(mean_pixels, np.float32)
                            if mean_pixels is not None else None)
        self.scale = scale
        if path_imgidx:
            self.imgrec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
            self.seq = list(self.imgrec.keys)
        else:
            self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
            self.seq = None
        if shuffle:
            assert self.seq is not None, "shuffle requires a .idx file"
        self.shuffle = shuffle
        if label_pad_width > 0:
            self.pad_width = label_pad_width
        else:
            self.pad_width = self._scan_label_widths(path_imgrec)
        self.provide_data = [DataDesc(data_name, (batch_size,) + data_shape)]
        self.provide_label = [DataDesc(label_name, (batch_size, 4 + self.pad_width))]
        self.cur = 0
        self.reset()

    @staticmethod
    def _scan_label_widths(path_imgrec):
        """The widest packed label of the file (one pass)."""
        rec = recordio.MXRecordIO(path_imgrec, "r")
        max_width = 0
        while True:
            s = rec.read()
            if s is None:
                break
            header, _ = recordio.unpack(s)
            width = header.label.size if isinstance(header.label, np.ndarray) else 1
            max_width = max(max_width, width)
        rec.close()
        return max_width

    def check_data_shape(self, data_shape):
        if len(data_shape) != 3 or data_shape[0] not in (1, 3):
            raise ValueError("data_shape must be (1|3, H, W), got %s" % (data_shape,))

    def reset(self):
        self.cur = 0
        if self.shuffle:
            np.random.shuffle(self.seq)
        if self.seq is None:
            self.imgrec.reset()

    def _next_record(self):
        if self.seq is not None:
            if self.cur >= len(self.seq):
                return None
            s = self.imgrec.read_idx(self.seq[self.cur])
            self.cur += 1
            return s
        return self.imgrec.read()

    def _flip_boxes(self, buf):
        """Mirror normalized x: xmin' = 1 - xmax, xmax' = 1 - xmin."""
        buf = buf.copy()
        header_width = int(buf[0])
        obj_width = int(buf[1])
        objs = buf[header_width:]
        n = objs.size // obj_width
        boxes = objs[:n * obj_width].reshape(n, obj_width)
        xmin = boxes[:, 1].copy()
        boxes[:, 1] = 1.0 - boxes[:, 3]
        boxes[:, 3] = 1.0 - xmin
        buf[header_width:header_width + n * obj_width] = boxes.ravel()
        return buf

    def next(self):
        try:
            from PIL import Image
        except ImportError as e:
            raise MXNetError("ImageDetIter resizes with PIL, which is not installed") from e

        c, h, w = self.data_shape
        data = np.zeros((self.batch_size, c, h, w), np.float32)
        label = np.full((self.batch_size, 4 + self.pad_width), self.label_pad_value, np.float32)
        n = 0
        while n < self.batch_size:
            s = self._next_record()
            if s is None:
                break
            header, img = recordio.unpack_img(s)
            im = Image.fromarray(img.astype(np.uint8))
            if c == 1:
                im = im.convert("L")
            arr = np.asarray(im.resize((w, h)), np.float32)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            buf = np.atleast_1d(np.asarray(header.label, np.float32))
            if buf.size > self.pad_width:
                raise MXNetError("label_pad_width %d smaller than record's label width %d"
                                 % (self.pad_width, buf.size))
            if self.rand_mirror and np.random.rand() < 0.5:
                arr = arr[:, ::-1, :]
                buf = self._flip_boxes(buf)
            if self.mean_pixels is not None:
                arr = arr - self.mean_pixels.reshape(1, 1, -1)
            data[n] = (arr * self.scale).transpose(2, 0, 1)
            label[n, 0] = c
            label[n, 1] = h
            label[n, 2] = w
            label[n, 3] = buf.size
            label[n, 4:4 + buf.size] = buf
            n += 1
        if n == 0:
            raise StopIteration
        return DataBatch([nd.array(data)], [nd.array(label)], self.batch_size - n)


class DetRecordIter(DataIter):
    """SSD-style detection feed (the reference's example/ssd
    DetRecordIter): ImageDetIter with each packed label row reshaped to
    (batch, max_objects, object_width), the [c, h, w, len] and packing
    headers stripped. provide_label is fixed up front from one batch."""

    def __init__(self, path_imgrec, batch_size, data_shape, path_imgidx=None, shuffle=False,
                 label_pad_width=-1, label_name="label", **kwargs):
        super().__init__()
        self._iter = ImageDetIter(batch_size=batch_size, data_shape=data_shape,
                                  path_imgrec=path_imgrec, path_imgidx=path_imgidx,
                                  shuffle=shuffle, label_pad_width=label_pad_width, **kwargs)
        self.batch_size = batch_size
        self.label_name = label_name
        self.provide_data = self._iter.provide_data
        first = self._iter.next().label[0].asnumpy()
        self._header_width = int(first[0, 4])
        self._obj_width = int(first[0, 5])
        self._start = 4 + self._header_width
        self._max_obj = (first.shape[1] - self._start) // self._obj_width
        if self._obj_width < 5:
            raise MXNetError("object width must be >= 5 (cls + 4 corners)")
        self.provide_label = [DataDesc(label_name,
                                       (batch_size, self._max_obj, self._obj_width))]
        self._iter.reset()

    def reset(self):
        self._iter.reset()

    def next(self):
        batch = self._iter.next()
        rows = batch.label[0].asnumpy()
        end = self._start + self._max_obj * self._obj_width
        boxes = rows[:, self._start:end].reshape(rows.shape[0], self._max_obj, self._obj_width)
        return DataBatch(batch.data, [nd.array(boxes)], batch.pad,
                         provide_data=self.provide_data, provide_label=self.provide_label)
