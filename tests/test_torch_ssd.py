"""SSD in the port (``mxnet_tpu_torch/models/ssd.py``) held against the
JAX package's on the CPU: the tests of ``tests/test_ssd.py`` on the port
(SSD-300's structure with its 8732 anchors, a tiny detector's training
and detection, the detection .rec contract and training from it), the
symbols' names and shapes equal to JAX's, and one whole-slice case: a tiny
SSD training step (MultiBoxPrior, MultiBoxTarget, the multi-output
SoftmaxOutput and the smooth-L1 head) in both packages from the same
parameters and batch, outputs within 1e-5 of their max (the class targets
equal) and every gradient within 1e-4; then its deploy graph's
detections, the kept classes equal."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import ssd as jssd
from mxnet_tpu_torch.models import ssd as tssd

FWD_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def test_ssd300_symbol_structure():
    net = tssd.get_symbol_train(num_classes=20)
    _, outs, _ = net.infer_shape(data=(2, 3, 300, 300), label=(2, 8, 5))
    by_name = dict(zip(net.list_outputs(), outs))
    assert by_name["cls_prob_output"] == (2, 21, 8732)
    assert by_name["loc_loss_output"] == (2, 8732 * 4)
    assert by_name["cls_label_output"] == (2, 8732)
    _, douts, _ = tssd.get_symbol(num_classes=20).infer_shape(data=(1, 3, 300, 300))
    assert douts[0] == (1, 8732, 6)


@pytest.mark.parametrize("deploy", [False, True])
def test_ssd300_names_and_shapes_match_jax(deploy):
    shapes = {"data": (2, 3, 300, 300)}
    if not deploy:
        shapes["label"] = (2, 8, 5)
    nets = []
    for pkg, mod in ((jmx, jssd), (tmx, tssd)):
        with pkg.NameManager():
            nets.append(mod.get_symbol(num_classes=20) if deploy
                        else mod.get_symbol_train(num_classes=20))
    j, t = nets
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.infer_shape(**shapes) == j.infer_shape(**shapes)


def _tiny_detector(pkg, mod, num_classes=3):
    s = pkg.sym
    data = s.Variable("data")
    r1 = s.Activation(s.Convolution(data, kernel=(3, 3), pad=(1, 1), stride=(2, 2),
                                    num_filter=8, name="c1"), act_type="relu")
    r2 = s.Activation(s.Convolution(r1, kernel=(3, 3), pad=(1, 1), stride=(2, 2),
                                    num_filter=8, name="c2"), act_type="relu")
    return mod.multibox_layer([r1, r2], num_classes, sizes=[(0.2, 0.3), (0.5, 0.6)],
                              ratios=[(1, 2), (1, 2, 0.5)], normalization=[-1, -1])


def _label(batch):
    label = -np.ones((batch, 4, 5), np.float32)
    label[0, 0] = [1, 0.1, 0.1, 0.5, 0.5]
    label[0, 1] = [0, 0.6, 0.6, 0.9, 0.9]
    label[1, 0] = [2, 0.3, 0.2, 0.8, 0.7]
    return label


def test_tiny_ssd_train_step():
    loc, cls, anchors = _tiny_detector(tmx, tssd)
    net = tssd.training_head(loc, cls, anchors, 3)
    mod = tmx.mod.Module(net, data_names=("data",), label_names=("label",), context=tmx.cpu())
    mod.bind(data_shapes=[("data", (2, 3, 16, 16))], label_shapes=[("label", (2, 4, 5))])
    mod.init_params(initializer=tmx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={"learning_rate": 0.1})
    metric = tssd.MultiBoxMetric()
    batch = tmx.io.DataBatch(data=[tmx.nd.array(np.random.RandomState(0).rand(2, 3, 16, 16))],
                             label=[tmx.nd.array(_label(2))])
    losses = []
    for _ in range(8):
        mod.forward(batch, is_train=True)
        metric.reset()
        mod.update_metric(metric, batch.label)
        mod.backward()
        mod.update()
        names, values = metric.get()
        assert names == ["CrossEntropy", "SmoothL1"] and np.isfinite(values[0])
        losses.append(values[0])
    assert losses[-1] < losses[0]


def _det_symbol(pkg, mod, num_classes=3, **kw):
    loc, cls_flat, anchors = _tiny_detector(pkg, mod, num_classes)
    s = pkg.sym
    cls = s.transpose(s.Reshape(cls_flat, shape=(0, -1, num_classes + 1)), axes=(0, 2, 1))
    prob = s.SoftmaxActivation(cls, mode="channel")
    return pkg.contrib.symbol.MultiBoxDetection(prob, loc, anchors, nms_threshold=0.5, **kw)


def test_tiny_ssd_detection_forward():
    exe = _det_symbol(tmx, tssd).simple_bind(ctx=tmx.cpu(), data=(1, 3, 16, 16))
    for name, arr in exe.arg_dict.items():
        if name != "data":
            arr[:] = np.random.RandomState(1).randn(*arr.shape) * 0.1
    exe.arg_dict["data"][:] = np.random.RandomState(2).rand(1, 3, 16, 16)
    out = exe.forward(is_train=False)[0].asnumpy()
    assert out.shape == (1, 8 * 8 * 3 + 4 * 4 * 4, 6)
    assert ((out[..., 0] >= -1) & (out[..., 0] < 3)).all()
    assert ((out[..., 1] >= 0) & (out[..., 1] <= 1)).all()


def _params(exe, seed, scale=0.1):
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*a.shape) * scale).astype(np.float32)
            for n, a in sorted(exe.arg_dict.items()) if n not in ("data", "label")}


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(float(np.abs(want).max()), 1.0),
                               err_msg=what)


def test_tiny_ssd_step_matches_jax():
    """The whole slice: one training step of the tiny SSD in both packages
    from the same parameters and batch."""
    rng = np.random.RandomState(3)
    data = rng.rand(2, 3, 16, 16).astype(np.float32)
    label = _label(2)
    res = []
    for pkg, mod in ((jmx, jssd), (tmx, tssd)):
        loc, cls, anchors = _tiny_detector(pkg, mod)
        net = mod.training_head(loc, cls, anchors, 3)
        exe = net.simple_bind(pkg.cpu(), data=(2, 3, 16, 16), label=(2, 4, 5))
        params = _params(exe, 4)
        for n, v in params.items():
            exe.arg_dict[n][:] = v
        exe.arg_dict["data"][:] = data
        exe.arg_dict["label"][:] = label
        exe.forward(is_train=True)
        outs = [o.asnumpy() for o in exe.outputs]
        exe.backward()
        res.append((outs, {n: exe.grad_dict[n].asnumpy() for n in params}))
    (jo, jg), (to, tg) = res
    for i, name in enumerate(("cls_prob", "loc_loss", "cls_label")):
        _close(to[i], jo[i], FWD_TOL, name)
    np.testing.assert_array_equal(to[2], jo[2])  # the matched classes
    assert (to[2] > 0).any()
    for n in jg:
        _close(tg[n], jg[n], GRAD_TOL, "grad " + n)


def test_tiny_ssd_detections_match_jax():
    outs = []
    for pkg, mod in ((jmx, jssd), (tmx, tssd)):
        exe = _det_symbol(pkg, mod, nms_topk=40).simple_bind(ctx=pkg.cpu(), data=(2, 3, 16, 16))
        for n, v in _params(exe, 5, scale=0.3).items():
            exe.arg_dict[n][:] = v
        exe.arg_dict["data"][:] = np.random.RandomState(6).rand(2, 3, 16, 16)
        outs.append(exe.forward(is_train=False)[0].asnumpy())
    j, t = outs
    np.testing.assert_array_equal(t[..., 0], j[..., 0])
    assert (t[..., 0] == -1).any() and (t[..., 0] >= 0).any()
    _close(t, j, FWD_TOL, "detections")


def _pack_det_rec(tmp_path, n_images=6, size=24):
    """Synthetic detection records as the reference SSD pipeline packs them:
    label [2, 5, (cls, xmin, ymin, xmax, ymax)...]."""
    from mxnet_tpu_torch import recordio

    rng = np.random.RandomState(3)
    rec_path, idx_path = str(tmp_path / "det.rec"), str(tmp_path / "det.idx")
    writer = recordio.MXIndexedRecordIO(idx_path, rec_path, "w")
    truths = []
    for i in range(n_images):
        img = (rng.rand(size, size, 3) * 255).astype(np.uint8)
        objs = []
        for _ in range(1 + i % 2):
            x0, y0 = rng.uniform(0.05, 0.4, 2)
            x1, y1 = x0 + rng.uniform(0.2, 0.5), y0 + rng.uniform(0.2, 0.5)
            objs.append([rng.randint(0, 3), x0, y0, min(x1, 0.95), min(y1, 0.95)])
        label = np.asarray([2, 5] + [v for o in objs for v in o], np.float32)
        writer.write_idx(i, recordio.pack_img(recordio.IRHeader(0, label, i, 0), img,
                                              img_fmt=".png"))
        truths.append(np.asarray(objs, np.float32))
    writer.close()
    return rec_path, idx_path, truths


def test_ssd_trains_from_rec_file(tmp_path):
    rec_path, idx_path, _ = _pack_det_rec(tmp_path)
    it = tmx.io.ImageDetRecordIter(path_imgrec=rec_path, path_imgidx=idx_path, batch_size=3,
                                   data_shape=(3, 16, 16), scale=1.0 / 255)
    loc, cls, anchors = _tiny_detector(tmx, tssd)
    mod = tmx.mod.Module(tssd.training_head(loc, cls, anchors, 3), data_names=("data",),
                         label_names=("label",), context=tmx.cpu())
    losses, metric = [], tssd.MultiBoxMetric()
    for _ in range(6):
        it.reset()
        for batch in it:
            label = batch.label[0].asnumpy()
            start = 4 + int(label[0, 4])
            width = int(label[0, 5])
            max_obj = (label.shape[1] - start) // width
            boxes = label[:, start:start + max_obj * width].reshape(3, max_obj, width)
            det = tmx.io.DataBatch(data=batch.data, label=[tmx.nd.array(boxes)])
            if not mod.binded:
                mod.bind(data_shapes=[("data", (3, 3, 16, 16))],
                         label_shapes=[("label", boxes.shape)])
                mod.init_params(initializer=tmx.init.Xavier())
                mod.init_optimizer(optimizer="sgd", optimizer_params={"learning_rate": 0.1})
            mod.forward(det, is_train=True)
            metric.reset()
            mod.update_metric(metric, det.label)
            mod.backward()
            mod.update()
            losses.append(metric.get()[1][0])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_train_ssd_example_two_steps_on_the_host(capsys):
    from mxnet_tpu_torch.examples import train_ssd

    mod = train_ssd.main(["--ctx", "cpu", "--num-epochs", "1", "--num-batches", "2",
                          "--batch-size", "4"])
    assert mod.binded and "epoch 0" in capsys.readouterr().out
