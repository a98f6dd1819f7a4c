"""SSD-300 detection network over a reduced VGG-16 (counterpart of
``mxnet_tpu/models/ssd.py``, the reference SSD example's
``symbol_vgg16_ssd_300.py``): a six-source feature pyramid, per-scale
location and class heads, ``MultiBoxPrior`` anchors (8732 at 300 x 300),
and a training head of ``MultiBoxTarget``, ``SoftmaxOutput(multi_output)``
and a smooth-L1 ``MakeLoss``, grouped into one multi-output symbol. The
deploy symbol decodes and suppresses through ``MultiBoxDetection``, whose
suppression loop is the NMS kernel on the card.
"""
from __future__ import annotations

from .. import initializer
from .. import symbol as sym
from ..contrib import symbol as contrib_sym


def _conv_act(data, name, num_filter, kernel=(3, 3), pad=(1, 1),
              stride=(1, 1), dilate=(1, 1)):
    net = sym.Convolution(data, kernel=kernel, pad=pad, stride=stride,
                          dilate=dilate, num_filter=num_filter, name=name)
    return sym.Activation(net, act_type="relu", name="relu_" + name)


def vgg16_reduced(data):
    """VGG-16 through conv5_3 with the SSD modifications: pool5 is 3x3
    stride-1, fc6/fc7 become dilated convolutions. Returns
    (conv4_3, relu7) — the first two feature sources."""
    net = data
    cfg = [(2, 64), (2, 128), (3, 256)]
    for i, (reps, filt) in enumerate(cfg):
        for j in range(reps):
            net = _conv_act(net, "conv%d_%d" % (i + 1, j + 1), filt)
        net = sym.Pooling(net, pool_type="max", kernel=(2, 2), stride=(2, 2),
                          pooling_convention="full", name="pool%d" % (i + 1))
    for j in range(3):
        net = _conv_act(net, "conv4_%d" % (j + 1), 512)
    conv4_3 = net
    net = sym.Pooling(net, pool_type="max", kernel=(2, 2), stride=(2, 2),
                      pooling_convention="full", name="pool4")
    for j in range(3):
        net = _conv_act(net, "conv5_%d" % (j + 1), 512)
    net = sym.Pooling(net, pool_type="max", kernel=(3, 3), stride=(1, 1),
                      pad=(1, 1), name="pool5")
    net = _conv_act(net, "fc6", 1024, kernel=(3, 3), pad=(6, 6),
                    dilate=(6, 6))
    net = _conv_act(net, "fc7", 1024, kernel=(1, 1), pad=(0, 0))
    return conv4_3, net


def _extra_layers(relu7):
    """SSD extra feature layers: 1x1 squeeze then 3x3 stride-2."""
    sources = []
    net = relu7
    cfg = [("6", 256, 512), ("7", 128, 256), ("8", 128, 256)]
    for suffix, squeeze, expand in cfg:
        net = _conv_act(net, "conv%s_1" % suffix, squeeze, kernel=(1, 1),
                        pad=(0, 0))
        net = _conv_act(net, "conv%s_2" % suffix, expand, kernel=(3, 3),
                        pad=(1, 1), stride=(2, 2))
        sources.append(net)
    pool6 = sym.Pooling(net, pool_type="avg", global_pool=True,
                        kernel=(1, 1), name="pool6")
    sources.append(pool6)
    return sources


# The SSD-300 anchor configuration (the reference's
# symbol_vgg16_ssd_300.py scales and ratios).
DEFAULT_SIZES = [
    (0.1, 0.141), (0.2, 0.272), (0.37, 0.447),
    (0.54, 0.619), (0.71, 0.79), (0.88, 0.961),
]
DEFAULT_RATIOS = [
    (1, 2, 0.5), (1, 2, 0.5, 3, 1.0 / 3), (1, 2, 0.5, 3, 1.0 / 3),
    (1, 2, 0.5, 3, 1.0 / 3), (1, 2, 0.5), (1, 2, 0.5),
]
DEFAULT_NORMALIZATION = [20, -1, -1, -1, -1, -1]


def multibox_layer(from_layers, num_classes, sizes=DEFAULT_SIZES,
                   ratios=DEFAULT_RATIOS, normalization=DEFAULT_NORMALIZATION,
                   clip=False):
    """Build per-scale loc/cls heads + anchors and concatenate.

    Returns (loc_preds [B, A*4], cls_preds [B, (C+1)*A] flattened-per-anchor,
    anchors [1, A, 4]).
    """
    loc_layers, cls_layers, anchor_layers = [], [], []
    num_label_classes = num_classes + 1  # background = class 0
    for k, from_layer in enumerate(from_layers):
        name = "mb%d" % k
        net = from_layer
        if normalization[k] > 0:
            net = sym.L2Normalization(net, mode="channel",
                                      name=name + "_l2norm")
            scale = sym.Variable(name + "_scale", shape=(1, 512, 1, 1),
                                 init=initializer.Constant(
                                     float(normalization[k])))
            net = sym.broadcast_mul(net, scale)
        size, ratio = sizes[k], ratios[k]
        num_anchors = len(size) + len(ratio) - 1

        loc = sym.Convolution(net, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * 4,
                              name=name + "_loc_pred_conv")
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc = sym.Flatten(loc)
        loc_layers.append(loc)

        cls = sym.Convolution(net, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * num_label_classes,
                              name=name + "_cls_pred_conv")
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls = sym.Flatten(cls)
        cls_layers.append(cls)

        anchors = contrib_sym.MultiBoxPrior(
            net, sizes=size, ratios=ratio, clip=clip,
            name=name + "_anchors")
        anchor_layers.append(anchors)

    loc_preds = sym.Concat(*loc_layers, dim=1, name="multibox_loc_pred")
    cls_preds = sym.Concat(*cls_layers, dim=1, name="multibox_cls_pred_flat")
    anchors = sym.Concat(*anchor_layers, dim=1, name="multibox_anchors")
    return loc_preds, cls_preds, anchors


def _build_heads(data, num_classes, **kwargs):
    conv4_3, relu7 = vgg16_reduced(data)
    sources = [conv4_3, relu7] + _extra_layers(relu7)
    return multibox_layer(sources, num_classes, **kwargs)


def get_symbol_train(num_classes=20, **kwargs):
    """Training symbol: Group([cls_prob, loc_loss, cls_label]).

    Mirrors the reference training head: MultiBoxTarget encodes anchors
    against ground truth; classification trains through
    SoftmaxOutput(multi_output, ignore_label=-1, normalization='valid');
    localisation trains through smooth-L1 MakeLoss masked to matched
    anchors. The label variable is [B, M, 5] rows of
    (class_id, x1, y1, x2, y2) in [0,1] corner format, class_id < 0 pad.
    """
    data = sym.Variable("data")
    loc_preds, cls_preds_flat, anchors = _build_heads(
        data, num_classes, **kwargs)
    return training_head(loc_preds, cls_preds_flat, anchors, num_classes)


def training_head(loc_preds, cls_preds_flat, anchors, num_classes):
    """Attach the SSD multi-loss training head to prediction symbols."""
    label = sym.Variable("label")
    num_label_classes = num_classes + 1
    # [B, A*(C+1)] anchor-major → [B, C+1, A] class-major for multi_output
    cls_preds = sym.Reshape(cls_preds_flat, shape=(0, -1, num_label_classes),
                            name="cls_pred_anchor_major")
    cls_preds = sym.transpose(cls_preds, axes=(0, 2, 1), name="multibox_cls_pred")
    loc_target, loc_target_mask, cls_target = contrib_sym.MultiBoxTarget(
        anchors, label, cls_preds, overlap_threshold=0.5,
        ignore_label=-1, negative_mining_ratio=3,
        minimum_negative_samples=0, negative_mining_thresh=0.5,
        variances=(0.1, 0.1, 0.2, 0.2), name="multibox_target")
    cls_prob = sym.SoftmaxOutput(cls_preds, cls_target,
                                 ignore_label=-1.0, multi_output=True,
                                 use_ignore=True, normalization="valid",
                                 name="cls_prob")
    loc_diff = loc_preds - loc_target
    masked_loc_diff = sym.broadcast_mul(loc_target_mask, loc_diff)
    loc_loss_ = sym.smooth_l1(masked_loc_diff, scalar=1.0,
                              name="loc_loss_")
    loc_loss = sym.MakeLoss(loc_loss_, grad_scale=1.0,
                            normalization="valid", name="loc_loss")
    cls_label = sym.MakeLoss(sym.BlockGrad(cls_target), grad_scale=0.0,
                             name="cls_label")
    return sym.Group([cls_prob, loc_loss, cls_label])


def get_symbol(num_classes=20, nms_thresh=0.5, force_suppress=False,
               nms_topk=400, **kwargs):
    """Deploy symbol: decoded + NMS'd detections [B, A, 6]."""
    data = sym.Variable("data")
    loc_preds, cls_preds_flat, anchors = _build_heads(
        data, num_classes, **kwargs)
    num_label_classes = num_classes + 1
    cls_preds = sym.Reshape(cls_preds_flat, shape=(0, -1, num_label_classes))
    cls_preds = sym.transpose(cls_preds, axes=(0, 2, 1))
    cls_prob = sym.SoftmaxActivation(cls_preds, mode="channel",
                                     name="cls_prob")
    return contrib_sym.MultiBoxDetection(
        cls_prob, loc_preds, anchors, name="detection",
        nms_threshold=nms_thresh, force_suppress=force_suppress,
        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=nms_topk)


class MultiBoxMetric(object):
    """Training metric of the SSD head (the reference SSD example's
    ``train/metric.py`` MultiBoxMetric): the cross-entropy of ``cls_prob``
    against the valid ``cls_label`` entries and the mean smooth-L1
    localisation loss, as two named values, through the EvalMetric
    interface ``Module.fit`` calls (update / reset / get /
    get_name_value)."""

    def __init__(self, eps=1e-8):
        self.eps = eps
        self.name = ["CrossEntropy", "SmoothL1"]
        self.reset()

    def reset(self):
        self.num_inst = [0, 0]
        self.sum_metric = [0.0, 0.0]

    def update(self, labels, preds):
        import numpy as np

        cls_prob = preds[0].asnumpy()   # [B, C+1, A]
        loc_loss = preds[1].asnumpy()   # [B, A*4]
        cls_label = preds[2].asnumpy()  # [B, A]
        valid = cls_label >= 0
        n_valid = int(valid.sum())
        label = cls_label.astype(int)
        b_idx, a_idx = np.nonzero(valid)
        prob = cls_prob[b_idx, label[b_idx, a_idx], a_idx]
        self.sum_metric[0] += float(-np.log(prob + self.eps).sum())
        self.num_inst[0] += n_valid
        self.sum_metric[1] += float(loc_loss.sum())
        self.num_inst[1] += n_valid

    def get(self):
        values = [
            s / n if n > 0 else float("nan")
            for s, n in zip(self.sum_metric, self.num_inst)
        ]
        return (self.name, values)

    def get_name_value(self):
        names, values = self.get()
        return list(zip(names, values))
