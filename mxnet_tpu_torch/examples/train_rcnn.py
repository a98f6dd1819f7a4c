"""Train Faster R-CNN end to end (counterpart of ``examples/train_rcnn.py``,
the reference R-CNN example's train_end2end.py): ``MutableModule`` over
images of several shapes, the ``Proposal`` operator, the
``proposal_target`` Python CustomOp and ``ROIPooling``.

A tiny backbone by default, on synthetic images (one bright square each)
made from the step number, cycling through three image shapes (the module
binds once at their maximum and rebinds, sharing its parameters, for each
other shape); ``--backbone vgg`` builds the VGG-16 graph of the reference
at 600 x 800. Runs on ``gpu(0)`` by default, on the host with ``--ctx
cpu``::

    python -m mxnet_tpu_torch.examples.train_rcnn --ctx cpu --steps 2
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import init, io
from ..context import cpu, gpu
from ..models import rcnn
from ..module import MutableModule
from ..ndarray import array

DATA_NAMES = ("data", "im_info", "gt_boxes")
LABEL_NAMES = ("rpn_label", "rpn_bbox_target", "rpn_bbox_weight")


def config(backbone):
    """(get_symbol_train kwargs, default shapes) of a backbone: the JAX
    example's tiny and VGG-16 settings."""
    tiny = backbone == "tiny"
    kw = dict(num_classes=3, backbone=backbone, feature_stride=4 if tiny else 16,
              scales=(2, 4) if tiny else (8, 16, 32), ratios=(1.0,) if tiny else (0.5, 1, 2),
              rpn_batch_size=32, batch_rois=16 if tiny else 128,
              rpn_pre_nms_top_n=64 if tiny else 6000, rpn_post_nms_top_n=16 if tiny else 300,
              rpn_min_size=2 if tiny else 16, pooled_size=(3, 3) if tiny else (7, 7),
              hidden=64 if tiny else 1024)
    shapes = [(32, 32), (32, 48), (48, 32)] if tiny else [(600, 800)]
    return kw, shapes


def make_batch(H, W, fs, scales, ratios, seed, ctx=None):
    """One synthetic image [1, 3, H, W] with a bright square, its gt box and
    RPN targets (``rcnn.assign_anchors``, which draws from numpy's global
    generator)."""
    rng = np.random.RandomState(seed)
    data = rng.rand(1, 3, H, W).astype(np.float32) * 0.3
    w = rng.randint(H // 4, H // 2)
    x, y = rng.randint(0, W - w), rng.randint(0, H - w)
    cls = rng.randint(0, 2)
    data[0, cls, y:y + w, x:x + w] += 0.6
    gt = np.array([[x, y, x + w, y + w, cls]], np.float32)
    lab, tgt, wgt = rcnn.assign_anchors(gt, (H // fs, W // fs), (H, W), feature_stride=fs,
                                        scales=scales, ratios=ratios, batch_size=32,
                                        fg_overlap=0.5, bg_overlap=0.3)
    return io.DataBatch(
        data=[array(data, ctx=ctx), array([[H, W, 1.0]], ctx=ctx), array(gt[None], ctx=ctx)],
        label=[array(lab, ctx=ctx), array(tgt, ctx=ctx), array(wgt, ctx=ctx)],
        provide_data=[("data", data.shape), ("im_info", (1, 3)), ("gt_boxes", (1,) + gt.shape)],
        provide_label=[("rpn_label", lab.shape), ("rpn_bbox_target", tgt.shape),
                       ("rpn_bbox_weight", wgt.shape)])


def build_module(net, kw, shapes, ctx):
    """A MutableModule bound at the largest of ``shapes``."""
    fs = kw["feature_stride"]
    max_h, max_w = max(s[0] for s in shapes), max(s[1] for s in shapes)
    a_n = len(kw["scales"]) * len(kw["ratios"])
    fh, fw = max_h // fs, max_w // fs
    return MutableModule(
        net, data_names=DATA_NAMES, label_names=LABEL_NAMES, context=ctx,
        max_data_shapes=[("data", (1, 3, max_h, max_w))],
        max_label_shapes=[("rpn_label", (1, a_n * fh, fw)),
                          ("rpn_bbox_target", (1, 4 * a_n, fh, fw)),
                          ("rpn_bbox_weight", (1, 4 * a_n, fh, fw))])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--backbone", default="tiny", choices=["tiny", "vgg"])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--lr", type=float, default=0.005)
    parser.add_argument("--ctx", type=str, default="gpu", choices=["gpu", "cpu"])
    args = parser.parse_args(argv)
    ctx = cpu() if args.ctx == "cpu" else gpu(0)
    kw, shapes = config(args.backbone)
    fs, scales, ratios = kw["feature_stride"], kw["scales"], kw["ratios"]
    net = rcnn.get_symbol_train(**kw)
    mod = build_module(net, kw, shapes, ctx)
    b0 = make_batch(*shapes[0], fs, scales, ratios, 0, ctx=ctx)
    mod.bind(data_shapes=b0.provide_data, label_shapes=b0.provide_label)
    mod.init_params(initializer=init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={"learning_rate": args.lr})
    for step in range(args.steps):
        batch = make_batch(*shapes[step % len(shapes)], fs, scales, ratios, step, ctx=ctx)
        mod.forward(batch, is_train=True)
        outs = [o.asnumpy() for o in mod.get_outputs()]
        mod.backward()
        mod.update()
        if step % 10 == 0:
            print("step %d rpn_bbox_loss %.4f bbox_loss %.4f"
                  % (step, outs[1].sum(), outs[3].sum()))
    print("rcnn example done (%d distinct shapes bound)" % len(mod._shape_modules))
    return mod


if __name__ == "__main__":
    main()
