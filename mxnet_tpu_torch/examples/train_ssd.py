"""Train SSD-300 detection (counterpart of ``examples/train_ssd.py``, the
reference SSD example's train/train_net.py).

With ``--data-train`` pointing at a detection ``.rec`` (ImageDetRecordIter
layout) the full VGG16-SSD-300 trains through ``Module.fit``. Without data
a tiny two-scale detector trains on synthetic images, one bright square
each, made from a seed. Runs on ``gpu(0)`` by default, on the host with
``--ctx cpu``::

    python -m mxnet_tpu_torch.examples.train_ssd --ctx cpu --num-epochs 1
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import callback, init, io
from ..context import cpu, gpu
from ..models import ssd
from ..ndarray import array
from ..symbol import Activation, Convolution, Variable
from .common import add_fit_args, get_module


def synthetic_det_batches(batch_size, num_batches=8, size=64, seed=0, ctx=None):
    """[B,3,S,S] images with one bright square each; label rows (cls, x1,
    y1, x2, y2) normalized, 4 a image, padded with -1."""
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(num_batches):
        data = rng.rand(batch_size, 3, size, size).astype(np.float32) * 0.2
        label = -np.ones((batch_size, 4, 5), np.float32)
        for b in range(batch_size):
            w = rng.randint(size // 4, size // 2)
            x = rng.randint(0, size - w)
            y = rng.randint(0, size - w)
            cls = rng.randint(0, 2)
            data[b, cls, y:y + w, x:x + w] += 0.7
            label[b, 0] = [cls, x / size, y / size, (x + w) / size, (y + w) / size]
        batches.append(io.DataBatch(
            data=[array(data, ctx=ctx)], label=[array(label, ctx=ctx)],
            provide_data=[("data", data.shape)], provide_label=[("label", label.shape)]))
    return batches


def tiny_ssd(num_classes):
    body = Variable("data")
    sources = []
    for k, nf in enumerate((16, 32)):
        body = Convolution(body, kernel=(3, 3), pad=(1, 1), stride=(2, 2), num_filter=nf,
                           name="c%d" % k)
        body = Activation(body, act_type="relu")
        sources.append(body)
    loc, cls, anchors = ssd.multibox_layer(
        sources, num_classes, sizes=[(0.3, 0.4), (0.6, 0.8)], ratios=[(1, 2, 0.5)] * 2,
        normalization=[-1, -1])
    return ssd.training_head(loc, cls, anchors, num_classes)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(parser)
    parser.add_argument("--data-train", type=str, default=None)
    parser.add_argument("--data-idx", type=str, default=None,
                        help=".idx file enabling shuffled epochs")
    parser.add_argument("--num-classes", type=int, default=20)
    parser.add_argument("--num-batches", type=int, default=8,
                        help="synthetic batches an epoch (without --data-train)")
    parser.set_defaults(batch_size=8, num_epochs=2, lr=0.05)
    args = parser.parse_args(argv)
    ctx = cpu() if args.ctx == "cpu" else gpu(0)
    if args.data_train:
        net = ssd.get_symbol_train(num_classes=args.num_classes)
        train = io.DetRecordIter(
            path_imgrec=args.data_train, path_imgidx=args.data_idx,
            batch_size=args.batch_size, data_shape=(3, 300, 300), scale=1.0 / 255,
            rand_mirror=True, shuffle=args.data_idx is not None)
        mod = get_module(args, net, data_names=("data",), label_names=("label",))
        mod.fit(train, optimizer="sgd",
                optimizer_params={"learning_rate": args.lr, "momentum": args.mom,
                                  "wd": args.wd},
                eval_metric=ssd.MultiBoxMetric(),
                kvstore="device" if args.num_devices > 1 else "local",
                batch_end_callback=callback.Speedometer(args.batch_size, 20),
                num_epoch=args.num_epochs)
        return mod
    num_classes = 2
    net = tiny_ssd(num_classes)
    batches = synthetic_det_batches(args.batch_size, args.num_batches, ctx=ctx)
    mod = get_module(args, net, data_names=("data",), label_names=("label",))
    mod.bind(data_shapes=batches[0].provide_data, label_shapes=batches[0].provide_label)
    mod.init_params(initializer=init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={"learning_rate": args.lr})
    mb = ssd.MultiBoxMetric()
    for epoch in range(args.num_epochs):
        mb.reset()
        for batch in batches:
            mod.forward(batch, is_train=True)
            mod.update_metric(mb, batch.label)
            mod.backward()
            mod.update()
        print("epoch %d %s" % (epoch, mb.get_name_value()))
    return mod


if __name__ == "__main__":
    main()
