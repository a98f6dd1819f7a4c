"""The port's image pipeline (``mxnet_tpu_torch/image.py``) on the CPU, held
to the JAX package (``mxnet_tpu/image.py``).

``imresize`` against ``jax.image.resize(..., "bilinear")`` shrinking,
enlarging and both at once, float and uint8 (rtol 1e-5 of 255: the
weights are JAX's in float64, the sums' order differs); every augmenter
and ``CreateAugmenter``'s list against JAX's on the same image after the
same ``random`` / ``np.random`` seeds (1e-4 absolute on 0..255 pixels;
crops, flips and casts exact); ``ImageIter`` batches, through
``from_recordio_params`` with rand_crop, rand_mirror, the mean and scale,
equal to JAX's for one seed (shuffled, with images smaller than the crop
so the resize runs), and with 4 threads equal to 1 thread without random
augmenters; ``imdecode`` and ``nd.imdecode`` (flag, clip_rect, mean, out);
the detection iterators' label layout ``[c, h, w, len, packed..., pad]``
and the SSD reshape against JAX's. Decode and augmentation never touch
CUDA: every batch here lands on ``cpu()``."""
import io as _io
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import image as jimage
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import image, recordio

PIL = pytest.importorskip("PIL")


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


@pytest.mark.parametrize("src,dst", [((37, 53), (20, 24)), ((20, 24), (37, 53)),
                                     ((30, 40), (45, 17)), ((64, 48), (64, 31)),
                                     ((7, 9), (7, 9))])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_imresize_matches_jax(src, dst, dtype):
    rng = np.random.RandomState(src[0] + dst[1])
    a = (rng.rand(src[0], src[1], 3) * 255).astype(dtype)
    want = _np(jimage.imresize(a, dst[1], dst[0]))
    got = image.imresize(a, dst[1], dst[0])
    assert isinstance(got, tmx.nd.NDArray) and got.context == tmx.cpu()
    got = got.asnumpy()
    assert got.shape == want.shape == (dst[0], dst[1], 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=255 * 1e-5)
    # an NDArray in gives an NDArray on its context, the same values
    np.testing.assert_array_equal(image.imresize(tmx.nd.array(a), dst[1], dst[0]).asnumpy(),
                                  got)


def test_resize_short_and_crops_match_jax():
    a = (np.random.RandomState(0).rand(30, 50, 3) * 255).astype(np.float32)
    np.testing.assert_allclose(_np(image.resize_short(a, 20)), _np(jimage.resize_short(a, 20)),
                               rtol=1e-5, atol=255 * 1e-5)
    assert image.scale_down((50, 30), (40, 40)) == jimage.scale_down((50, 30), (40, 40))
    for fn in ("center_crop", "random_crop", "random_size_crop"):
        random.seed(3)
        np.random.seed(3)
        want, wbox = getattr(jimage, fn)(a, (16, 12))
        random.seed(3)
        np.random.seed(3)
        got, gbox = getattr(image, fn)(a, (16, 12))
        assert gbox == wbox, fn
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=255 * 1e-5)


AUGS = {
    "resize": lambda m: m.ResizeAug(20),
    "rand_crop": lambda m: m.RandomCropAug((16, 20)),
    "rand_sized_crop": lambda m: m.RandomSizedCropAug((16, 20), 0.3, (0.75, 1.333)),
    "center_crop": lambda m: m.CenterCropAug((16, 20)),
    "flip": lambda m: m.HorizontalFlipAug(0.5),
    "cast": lambda m: m.CastAug(),
    "color_jitter": lambda m: m.ColorJitterAug(0.3, 0.3, 0.3),
    "lighting": lambda m: m.LightingAug(0.1, np.array([55.46, 4.794, 1.148]),
                                        np.array([[-0.5675, 0.7192, 0.4009],
                                                  [-0.5808, -0.0045, -0.8140],
                                                  [-0.5836, -0.6948, 0.4203]])),
    "normalize": lambda m: m.ColorNormalizeAug(np.array([123.68, 116.28, 103.53]),
                                               np.array([58.395, 57.12, 57.375])),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmenters_match_jax(name):
    a = (np.random.RandomState(1).rand(28, 36, 3) * 255).astype(np.float32)
    for seed in range(4):
        random.seed(seed)
        np.random.seed(seed)
        want = [_np(x) for x in AUGS[name](jimage)(a.copy())]
        random.seed(seed)
        np.random.seed(seed)
        got = AUGS[name](image)(a.copy())
        assert all(isinstance(x, np.ndarray) for x in got)  # numpy in, numpy out
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=1e-5, atol=1e-4)


def test_augmenter_on_ndarray_stays_on_its_context():
    a = tmx.nd.array(np.random.RandomState(2).rand(10, 12, 3).astype(np.float32) * 255)
    for name in ("flip", "color_jitter", "normalize", "resize"):
        random.seed(0)
        out = AUGS[name](image)(a)
        assert all(isinstance(o, tmx.nd.NDArray) and o.context == tmx.cpu() for o in out)


@pytest.mark.parametrize("kw", [
    dict(), dict(rand_crop=True, rand_mirror=True), dict(resize=24, mean=True, std=True),
    dict(rand_crop=True, rand_resize=True, brightness=0.2, contrast=0.2, saturation=0.2,
         pca_noise=0.1)])
def test_create_augmenter_matches_jax(kw):
    a = (np.random.RandomState(5).rand(30, 40, 3) * 255).astype(np.float32)
    jl = jimage.CreateAugmenter((3, 16, 20), **kw)
    tl = image.CreateAugmenter((3, 16, 20), **kw)
    assert len(jl) == len(tl)
    for seed in range(3):
        outs = []
        for augs in (jl, tl):
            random.seed(seed)
            np.random.seed(seed)
            data = [a.copy()]
            for aug in augs:
                data = [r for s in data for r in aug(s)]
            outs.append([_np(d) for d in data])
        for g, w in zip(outs[1], outs[0]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-3)


def _pack_images(tmp_path, n, seed=0, sizes=(14, 40), fmt=".png"):
    rng = np.random.RandomState(seed)
    rec, idx = str(tmp_path / "img.rec"), str(tmp_path / "img.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        h, wd = rng.randint(*sizes, size=2)
        img = rng.randint(0, 255, (h, wd, 3)).astype(np.uint8)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(i % 10), i, 0), img,
                                         img_fmt=fmt))
    w.close()
    return rec, idx


def _batches(it, n=None):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        if n is not None and len(out) == n:
            break
    return out


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
def test_image_record_iter_batches_equal_jax(tmp_path, fmt):
    rec, idx = _pack_images(tmp_path, 37, fmt=fmt)
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 20, 20), batch_size=8,
              shuffle=True, rand_crop=True, rand_mirror=True, mean_r=120.0, mean_g=110.0,
              mean_b=100.0, scale=1.0 / 64, preprocess_threads=1, input_workers=0)
    runs = []
    for mx in (jmx, tmx):
        random.seed(11)
        np.random.seed(11)
        it = mx.io.ImageRecordIter(**kw)
        first = _batches(it)
        it.reset()
        runs.append(first + _batches(it, 2))
    assert len(runs[0]) == len(runs[1]) == 7 and runs[1][4][2] == 3  # 37 = 4 * 8 + 5
    for (gd, gl, gp), (wd, wl, wp) in zip(runs[1], runs[0]):
        assert gp == wp
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)


def test_image_iter_threads_match_one_thread(tmp_path):
    rec, idx = _pack_images(tmp_path, 30, sizes=(20, 30))
    runs = []
    for threads in (1, 4):
        it = image.ImageIter(6, (3, 20, 20), path_imgrec=rec, path_imgidx=idx,
                             preprocess_threads=threads)
        runs.append(_batches(it))
    assert len(runs[0]) == 5
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_image_iter_from_an_image_list(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(4)
    lst = []
    for i in range(5):
        Image.fromarray(rng.randint(0, 255, (24, 24, 3)).astype(np.uint8)).save(
            tmp_path / ("%d.png" % i))
        lst.append("%d\t%d\t%d.png" % (i, i, i))
    (tmp_path / "x.lst").write_text("\n".join(lst) + "\n")
    outs = []
    for mod in (jimage, image):
        it = mod.ImageIter(2, (3, 24, 24), path_imglist=str(tmp_path / "x.lst"),
                           path_root=str(tmp_path))
        outs.append(_batches(it))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]


def test_imdecode_matches_jax():
    from PIL import Image

    img = np.random.RandomState(6).randint(0, 255, (18, 22, 3)).astype(np.uint8)
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    data = buf.getvalue()
    np.testing.assert_array_equal(image.imdecode(data).asnumpy(), _np(jimage.imdecode(data)))
    for kw in (dict(), dict(flag=0), dict(clip_rect=(2, 3, 12, 15)),
               dict(mean=np.array([10.0, 20.0, 30.0], np.float32))):
        want = jmx.nd.imdecode(data, **kw).asnumpy()
        got = tmx.nd.imdecode(data, **kw)
        assert got.context == tmx.cpu()
        np.testing.assert_allclose(got.asnumpy(), want, rtol=0, atol=1e-5)
    out = tmx.nd.zeros((18, 22, 3))
    assert tmx.nd.imdecode(data, out=out) is out
    np.testing.assert_array_equal(out.asnumpy(), img.astype(np.float32))
    with pytest.raises(tmx.MXNetError, match="unsupported"):
        tmx.nd.imdecode(data, to_rgb=0)


def _pack_det(tmp_path, n=7):
    rng = np.random.RandomState(8)
    rec = str(tmp_path / "det.rec")
    w = recordio.MXRecordIO(rec, "w")
    for i in range(n):
        k = 1 + i % 3
        boxes = []
        for _ in range(k):
            x0, y0 = rng.uniform(0, 0.5, 2)
            boxes += [float(rng.randint(3)), x0, y0, x0 + 0.3, y0 + 0.4]
        label = np.array([2, 5] + boxes, np.float32)
        img = rng.randint(0, 255, (20, 26, 3)).astype(np.uint8)
        w.write(recordio.pack_img(recordio.IRHeader(0, label, i, 0), img, img_fmt=".png"))
    w.close()
    return rec


def test_detection_iters_match_jax(tmp_path):
    rec = _pack_det(tmp_path)
    kw = dict(path_imgrec=rec, batch_size=3, data_shape=(3, 16, 16), rand_mirror=True,
              mean_pixels=[10, 20, 30], scale=0.5)
    outs = []
    for mx in (jmx, tmx):
        np.random.seed(2)
        it = mx.io.ImageDetRecordIter(**kw)
        outs.append((it.provide_label, _batches(it)))
    assert outs[0][0][0][1] == tuple(outs[1][0][0][1]) == (3, 4 + 17)
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(b[0], a[0], rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(b[1], a[1])
        assert a[2] == b[2]
    det = []
    for mx in (jmx, tmx):
        np.random.seed(2)
        it = mx.io.DetRecordIter(path_imgrec=rec, batch_size=3, data_shape=(3, 16, 16))
        det.append((tuple(it.provide_label[0][1]), _batches(it)))
    assert det[0][0] == det[1][0] == (3, 3, 5)
    for a, b in zip(det[0][1], det[1][1]):
        np.testing.assert_array_equal(b[1], a[1])
    with pytest.raises(TypeError, match="unsupported"):
        image.ImageDetIter(2, (3, 16, 16), rec, not_a_param=1)
