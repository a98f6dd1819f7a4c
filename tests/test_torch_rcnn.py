"""Faster R-CNN in the port (``mxnet_tpu_torch/models/rcnn.py``) held
against the JAX package's on the CPU: the tests of ``tests/test_rcnn.py``
on the port (the ``proposal_target`` CustomOp, an end-to-end
``MutableModule`` run over two image shapes, a forced rebind that keeps
the parameters, training from a detection .rec), ``assign_anchors`` and
``generate_anchors`` equal to JAX's from one numpy seed, the VGG-16
graph's names and shapes equal, and the whole slice: the tiny R-CNN's
training step in both packages from the same parameters and batch (rois
index-equal, outputs within 1e-5 of their max, every gradient within
1e-4), then two ``MutableModule`` steps over two shapes with the same
parameters after them (1e-4)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import rcnn as jrcnn
from mxnet_tpu_torch.models import rcnn as trcnn

FS, SCALES, RATIOS = 4, (2, 4), (1.0,)
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
PKGS = ((jmx, jrcnn), (tmx, trcnn))


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _make_symbol(mod):
    return mod.get_symbol_train(num_classes=3, backbone="tiny", feature_stride=FS,
                                scales=SCALES, ratios=RATIOS, rpn_batch_size=16, batch_rois=8,
                                rpn_pre_nms_top_n=32, rpn_post_nms_top_n=16, rpn_min_size=2,
                                pooled_size=(3, 3), hidden=32)


def _make_batch(pkg, mod, im_hw, seed=0):
    H, W = im_hw
    rng = np.random.RandomState(seed)
    data = rng.rand(1, 3, H, W).astype(np.float32)
    gt = np.array([[2.0, 2.0, H * 0.6, W * 0.6, 0.0],
                   [H * 0.3, W * 0.3, H - 3.0, W - 3.0, 1.0]], np.float32)
    np.random.seed(seed)  # assign_anchors samples from numpy's global generator
    lab, tgt, wgt = mod.assign_anchors(gt, (H // FS, W // FS), (H, W), feature_stride=FS,
                                       scales=SCALES, ratios=RATIOS, batch_size=16,
                                       fg_overlap=0.5, bg_overlap=0.3)
    nd = pkg.nd
    return pkg.io.DataBatch(
        data=[nd.array(data), nd.array(np.array([[H, W, 1.0]], np.float32)), nd.array(gt[None])],
        label=[nd.array(lab), nd.array(tgt), nd.array(wgt)],
        provide_data=[("data", data.shape), ("im_info", (1, 3)), ("gt_boxes", (1,) + gt.shape)],
        provide_label=[("rpn_label", lab.shape), ("rpn_bbox_target", tgt.shape),
                       ("rpn_bbox_weight", wgt.shape)])


def _mutable(pkg, net, **kw):
    return pkg.mod.MutableModule(
        net, data_names=("data", "im_info", "gt_boxes"),
        label_names=("rpn_label", "rpn_bbox_target", "rpn_bbox_weight"), context=pkg.cpu(),
        **kw)


def test_proposal_target_custom_op():
    rois = np.array([[0, 0, 0, 10, 10], [0, 1, 1, 12, 12], [0, 20, 20, 30, 30]], np.float32)
    gt = np.array([[[0, 0, 11, 11, 1.0]]], np.float32)
    outs = []
    for pkg, _ in PKGS:
        out = pkg.sym.Custom(pkg.sym.Variable("rois"), pkg.sym.Variable("gt"),
                             op_type="proposal_target", num_classes=3, batch_rois=4,
                             fg_fraction=0.5)
        exe = out.simple_bind(pkg.cpu(), rois=(3, 5), gt=(1, 1, 5))
        exe.arg_dict["rois"][:] = rois
        exe.arg_dict["gt"][:] = gt
        outs.append([o.asnumpy() for o in exe.forward()])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    sampled, label, bt, bw = outs[1]
    assert sampled.shape == (4, 5) and label.shape == (4,)
    assert bt.shape == (4, 12) and bw.shape == (4, 12)
    assert (label == 2).sum() >= 2
    fg = label == 2
    assert bw[fg][:, 8:12].all() and not bw[fg][:, :8].any() and not bw[~fg].any()


def test_assign_and_generate_anchors_match_jax():
    gt = np.array([[3, 4, 40, 30, 0], [20, 10, 60, 50, 1], [0, 0, 0, 0, -1]], np.float32)
    for fs, scales, ratios in ((16, (8, 16, 32), (0.5, 1, 2)), (FS, SCALES, RATIOS)):
        np.testing.assert_array_equal(trcnn.generate_anchors(fs, scales, ratios),
                                      jrcnn.generate_anchors(fs, scales, ratios))
        got = []
        for mod in (jrcnn, trcnn):
            np.random.seed(3)
            got.append(mod.assign_anchors(gt, (64 // fs, 80 // fs), (64, 80), feature_stride=fs,
                                          scales=scales, ratios=ratios, batch_size=16))
        for a, b in zip(*got):
            np.testing.assert_array_equal(a, b)


def test_vgg_graph_names_and_shapes_match_jax():
    nets = []
    for pkg, mod in PKGS:
        with pkg.NameManager():
            nets.append(mod.get_symbol_train(num_classes=21))
    j, t = nets
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    shapes = dict(data=(1, 3, 600, 800), im_info=(1, 3), gt_boxes=(1, 4, 5),
                  rpn_label=(1, 9 * 37, 50), rpn_bbox_target=(1, 36, 37, 50),
                  rpn_bbox_weight=(1, 36, 37, 50))
    assert t.infer_shape(**shapes) == j.infer_shape(**shapes)


def _params(exe, seed):
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*a.shape) * (0.1 if n.endswith("bias") else 0.3)).astype(np.float32)
            for n, a in sorted(exe.arg_dict.items())
            if n.endswith(("weight", "bias"))}


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(float(np.abs(want).max()), 1.0),
                               err_msg=what)


def test_tiny_rcnn_step_matches_jax():
    """The whole slice at the executor: the rois (Proposal's output) and
    every output, then every gradient."""
    res = []
    for pkg, mod in PKGS:
        net = _make_symbol(mod)
        full = pkg.sym.Group([net, net.get_internals()["rois_output"]])
        batch = _make_batch(pkg, mod, (32, 32), seed=0)
        shapes = dict(batch.provide_data + batch.provide_label)
        exe = full.simple_bind(pkg.cpu(), **shapes)
        params = _params(exe, 1)
        for n, v in params.items():
            exe.arg_dict[n][:] = v
        for (n, _), arr in zip(batch.provide_data + batch.provide_label,
                               batch.data + batch.label):
            exe.arg_dict[n][:] = arr.asnumpy()
        exe.forward(is_train=True)
        outs = [o.asnumpy() for o in exe.outputs]
        exe.backward()
        res.append((outs, {n: exe.grad_dict[n].asnumpy() for n in params}))
    (jo, jg), (to, tg) = res
    _close(to[-1], jo[-1], FWD_TOL, "rois")
    np.testing.assert_array_equal(to[4], jo[4])  # proposal_target's labels
    assert (to[4] > 0).any()
    for i in range(4):
        _close(to[i], jo[i], FWD_TOL, "output %d" % i)
    for n in jg:
        _close(tg[n], jg[n], GRAD_TOL, "grad " + n)


def test_tiny_rcnn_mutable_module_steps_match_jax():
    """Two SGD steps through MutableModule, the second on another shape
    (the rebind), from the same parameters: the outputs of each step and
    the parameters after them."""
    res = []
    for pkg, mod in PKGS:
        net = _make_symbol(mod)
        m = _mutable(pkg, net, max_data_shapes=[("data", (1, 3, 32, 32))])
        b0 = _make_batch(pkg, mod, (32, 32), seed=0)
        m.bind(data_shapes=b0.provide_data, label_shapes=b0.provide_label)
        m.init_params(initializer=pkg.init.Xavier())
        arg, aux = m.get_params()
        exe_params = {n: (np.random.RandomState(len(n)).randn(*a.shape) * 0.2).astype(np.float32)
                      for n, a in sorted(arg.items())}
        m.set_params({n: pkg.nd.array(v) for n, v in exe_params.items()}, aux)
        m.init_optimizer(optimizer="sgd", optimizer_params={"learning_rate": 0.01})
        outs = []
        for seed, hw in ((0, (32, 32)), (1, (16, 32))):
            batch = _make_batch(pkg, mod, hw, seed=seed)
            m.forward(batch, is_train=True)
            outs.append([o.asnumpy() for o in m.get_outputs()])
            m.backward()
            m.update()
        assert m._curr_module is not m._base_module
        res.append((outs, {n: v.asnumpy() for n, v in m.get_params()[0].items()}))
    (jo, jp), (to, tp) = res
    for s, (a, b) in enumerate(zip(to, jo)):
        np.testing.assert_array_equal(a[4], b[4])
        for i in range(4):
            _close(a[i], b[i], FWD_TOL, "step %d output %d" % (s, i))
    for n in jp:
        _close(tp[n], jp[n], GRAD_TOL, "param " + n)


def test_rcnn_end2end_mutable_module():
    net = _make_symbol(trcnn)
    b32 = _make_batch(tmx, trcnn, (32, 32), seed=0)
    b16 = _make_batch(tmx, trcnn, (16, 32), seed=1)
    mod = _mutable(tmx, net, max_data_shapes=[("data", (1, 3, 32, 32))])
    mod.bind(data_shapes=b32.provide_data, label_shapes=b32.provide_label)
    mod.init_params(initializer=tmx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={"learning_rate": 0.01})
    assert mod._curr_module is mod._base_module
    for step, batch in enumerate([b32, b32, b16, b32]):
        mod.forward(batch, is_train=True)
        if step == 2:
            assert mod._curr_module is not mod._base_module
        outs = [o.asnumpy() for o in mod.get_outputs()]
        assert all(np.isfinite(o).all() for o in outs), step
        mod.backward()
        mod.update()
    np.testing.assert_allclose(outs[2].sum(axis=1), 1.0, rtol=1e-4)


def test_mutable_module_force_rebind_keeps_params():
    net = _make_symbol(trcnn)
    b32 = _make_batch(tmx, trcnn, (32, 32), seed=0)
    mod = _mutable(tmx, net)
    mod.bind(data_shapes=b32.provide_data, label_shapes=b32.provide_label)
    mod.init_params(initializer=tmx.init.Xavier())
    before, _ = mod.get_params()
    mod.bind(data_shapes=b32.provide_data, label_shapes=b32.provide_label, force_rebind=True)
    assert mod.params_initialized
    after, _ = mod.get_params()
    for name in before:
        np.testing.assert_allclose(after[name].asnumpy(), before[name].asnumpy(), rtol=1e-6)
    mod.forward(b32, is_train=False)
    assert np.isfinite(mod.get_outputs()[0].asnumpy()).all()


def test_rcnn_trains_from_det_rec_file(tmp_path):
    from mxnet_tpu_torch import recordio

    rng = np.random.RandomState(5)
    rec_path, idx_path = str(tmp_path / "rcnn.rec"), str(tmp_path / "rcnn.idx")
    writer = recordio.MXIndexedRecordIO(idx_path, rec_path, "w")
    for i in range(4):
        img = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
        x0, y0 = rng.uniform(0.1, 0.3, 2)
        label = np.asarray([2, 5, i % 2, x0, y0, x0 + 0.5, y0 + 0.5], np.float32)
        writer.write_idx(i, recordio.pack_img(recordio.IRHeader(0, label, i, 0), img,
                                              img_fmt=".png"))
    writer.close()
    H = W = 32
    it = tmx.io.ImageDetRecordIter(path_imgrec=rec_path, path_imgidx=idx_path, batch_size=1,
                                   data_shape=(3, H, W), scale=1.0 / 255, label_pad_width=8)
    mod = _mutable(tmx, _make_symbol(trcnn), max_data_shapes=[("data", (1, 3, H, W))])
    losses = []
    for _ in range(3):
        it.reset()
        for batch in it:
            row = batch.label[0].asnumpy()[0]
            objs = row[4 + int(row[4]):4 + int(row[3])].reshape(-1, int(row[5]))
            gt = np.stack([objs[:, 1] * W, objs[:, 2] * H, objs[:, 3] * W, objs[:, 4] * H,
                           objs[:, 0]], axis=1).astype(np.float32)
            lab, tgt, wgt = trcnn.assign_anchors(gt, (H // FS, W // FS), (H, W),
                                                 feature_stride=FS, scales=SCALES,
                                                 ratios=RATIOS, batch_size=16, fg_overlap=0.5,
                                                 bg_overlap=0.3)
            fb = tmx.io.DataBatch(
                data=[batch.data[0], tmx.nd.array([[H, W, 1.0]]), tmx.nd.array(gt[None])],
                label=[tmx.nd.array(lab), tmx.nd.array(tgt), tmx.nd.array(wgt)],
                provide_data=[("data", (1, 3, H, W)), ("im_info", (1, 3)),
                              ("gt_boxes", (1,) + gt.shape)],
                provide_label=[("rpn_label", lab.shape), ("rpn_bbox_target", tgt.shape),
                               ("rpn_bbox_weight", wgt.shape)])
            if not mod.binded:
                mod.bind(data_shapes=fb.provide_data, label_shapes=fb.provide_label)
                mod.init_params(initializer=tmx.init.Xavier())
                mod.init_optimizer(optimizer="sgd", optimizer_params={"learning_rate": 0.01})
            mod.forward(fb, is_train=True)
            outs = [o.asnumpy() for o in mod.get_outputs()]
            assert all(np.isfinite(o).all() for o in outs)
            mod.backward()
            mod.update()
            probs = outs[0].reshape(2, -1)
            mask = lab.ravel() != -1
            pick = probs[lab.ravel()[mask].astype(int), np.where(mask)[0]]
            losses.append(float(-np.log(pick + 1e-8).mean()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_train_rcnn_example_two_steps_on_the_host(capsys):
    from mxnet_tpu_torch.examples import train_rcnn

    mod = train_rcnn.main(["--ctx", "cpu", "--steps", "2"])
    assert mod.binded and "rcnn example done" in capsys.readouterr().out
