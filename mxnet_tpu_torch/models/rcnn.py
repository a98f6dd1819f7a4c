"""Faster R-CNN end-to-end training graph (counterpart of
``mxnet_tpu/models/rcnn.py``, the reference R-CNN example): an RPN over a
conv backbone (VGG-16, or a tiny one for tests), the ``Proposal``
operator, the ``proposal_target`` Python CustomOp, ``ROIPooling`` and a
two-head Fast R-CNN top, grouped into a five-output training symbol that
``MutableModule`` drives over images of several shapes. The roi counts
are static (``rpn_post_nms_top_n``, ``batch_rois``). ``assign_anchors`` is
the host's RPN target assignment (the reference's AnchorLoader); it draws
from numpy's global generator.
"""
from __future__ import annotations

import numpy as np

from .. import operator
from .. import symbol as sym
from ..contrib import symbol as contrib_sym


# --------------------------------------------------------------------------
# proposal_target: python CustomOp sampling rois against ground truth
# --------------------------------------------------------------------------

def _bbox_transform(ex_rois, gt_rois):
    """Encode gt boxes relative to example rois (dx,dy,dw,dh)."""
    ew = ex_rois[:, 2] - ex_rois[:, 0] + 1.0
    eh = ex_rois[:, 3] - ex_rois[:, 1] + 1.0
    ecx = ex_rois[:, 0] + 0.5 * (ew - 1.0)
    ecy = ex_rois[:, 1] + 0.5 * (eh - 1.0)
    gw = gt_rois[:, 2] - gt_rois[:, 0] + 1.0
    gh = gt_rois[:, 3] - gt_rois[:, 1] + 1.0
    gcx = gt_rois[:, 0] + 0.5 * (gw - 1.0)
    gcy = gt_rois[:, 1] + 0.5 * (gh - 1.0)
    return np.stack([
        (gcx - ecx) / ew, (gcy - ecy) / eh,
        np.log(gw / ew), np.log(gh / eh),
    ], axis=-1).astype(np.float32)


def _np_iou(a, b):
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    iw = np.maximum(ix2 - ix1 + 1.0, 0.0)
    ih = np.maximum(iy2 - iy1 + 1.0, 0.0)
    inter = iw * ih
    aa = (a[:, 2] - a[:, 0] + 1.0) * (a[:, 3] - a[:, 1] + 1.0)
    ab = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    union = aa[:, None] + ab[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


@operator.register("proposal_target")
class ProposalTargetProp(operator.CustomOpProp):
    """Sample a fixed-size roi batch and produce Fast R-CNN head targets.

    Inputs: rois [N, 5] (batch_idx, x1, y1, x2, y2), gt_boxes
    [1, M, 5] (x1, y1, x2, y2, cls; cls is the 0-based FOREGROUND class
    id — output label = cls + 1, 0 = background; cls < 0 rows are
    padding — the leading batch dim keeps every module input
    batch-major).
    Outputs (all length ``batch_rois``, a static count): sampled rois,
    per-roi class label (0 = background), class-placed bbox targets
    [R, 4*num_classes] and matching weights.
    """

    def __init__(self, num_classes=21, batch_rois=128, fg_fraction=0.25,
                 fg_overlap=0.5):
        super().__init__(need_top_grad=False)
        self._num_classes = int(num_classes)
        self._batch_rois = int(batch_rois)
        self._fg_fraction = float(fg_fraction)
        self._fg_overlap = float(fg_overlap)

    def list_arguments(self):
        return ["rois", "gt_boxes"]

    def list_outputs(self):
        return ["rois_output", "label", "bbox_target", "bbox_weight"]

    def infer_shape(self, in_shape):
        rois_shape, gt_shape = in_shape
        R, C = self._batch_rois, self._num_classes
        return ([rois_shape, gt_shape],
                [(R, 5), (R,), (R, 4 * C), (R, 4 * C)], [])

    def create_operator(self, ctx, in_shapes, in_dtypes):
        num_classes = self._num_classes
        batch_rois = self._batch_rois
        fg_rois = int(round(self._batch_rois * self._fg_fraction))
        fg_overlap = self._fg_overlap

        class ProposalTarget(operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                rois = in_data[0].asnumpy()
                gt = in_data[1].asnumpy().reshape(-1, 5)
                gt = gt[gt[:, 4] >= 0]
                # ground-truth boxes participate as candidate rois
                # (guarantees foreground samples early in training)
                if len(gt):
                    gt_as_rois = np.concatenate(
                        [np.zeros((len(gt), 1), np.float32), gt[:, :4]],
                        axis=1)
                    all_rois = np.concatenate([rois, gt_as_rois], axis=0)
                else:
                    all_rois = rois

                R = batch_rois
                labels = np.zeros((R,), np.float32)
                targets = np.zeros((R, 4 * num_classes), np.float32)
                weights = np.zeros((R, 4 * num_classes), np.float32)
                if len(gt):
                    iou = _np_iou(all_rois[:, 1:5], gt[:, :4])
                    max_iou = iou.max(axis=1)
                    argmax = iou.argmax(axis=1)
                    fg_idx = np.where(max_iou >= fg_overlap)[0]
                    bg_idx = np.where(max_iou < fg_overlap)[0]
                    if len(fg_idx) > fg_rois:
                        fg_idx = fg_idx[
                            np.argsort(-max_iou[fg_idx])[:fg_rois]]
                    n_fg = len(fg_idx)
                    n_bg = R - n_fg
                    if len(bg_idx) == 0:
                        # no true background: pad with the LOWEST-overlap
                        # rois; they are labeled below by their own
                        # overlap, so a fg roi is never mislabeled bg
                        bg_idx = np.argsort(max_iou)[:1]
                    bg_take = np.resize(bg_idx, n_bg)
                    keep = np.concatenate([fg_idx, bg_take])
                    sampled = all_rois[keep]
                    # label every slot from ITS OWN overlap (padding
                    # duplicates of a fg roi keep their fg class)
                    slot_fg = max_iou[keep] >= fg_overlap
                    labels[:] = np.where(
                        slot_fg, gt[argmax[keep], 4] + 1.0, 0.0)
                    if slot_fg.any():
                        t = _bbox_transform(sampled[:, 1:5],
                                            gt[argmax[keep], :4])
                        for i in np.where(slot_fg)[0]:
                            c = int(labels[i])
                            targets[i, 4 * c:4 * c + 4] = t[i]
                            weights[i, 4 * c:4 * c + 4] = 1.0
                else:
                    sampled = np.resize(all_rois, (R, 5))
                self.assign(out_data[0], req[0], sampled.astype(np.float32))
                self.assign(out_data[1], req[1], labels)
                self.assign(out_data[2], req[2], targets)
                self.assign(out_data[3], req[3], weights)

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                self.assign(in_grad[0], req[0],
                            np.zeros_like(in_data[0].asnumpy()))
                self.assign(in_grad[1], req[1],
                            np.zeros_like(in_data[1].asnumpy()))

        return ProposalTarget()


# --------------------------------------------------------------------------
# symbols
# --------------------------------------------------------------------------

def _vgg_feat(data):
    """VGG-16 conv body through conv5_3 (feature stride 16)."""
    net = data
    for i, (reps, filt) in enumerate(
            [(2, 64), (2, 128), (3, 256), (3, 512)]):
        for j in range(reps):
            net = sym.Convolution(net, kernel=(3, 3), pad=(1, 1),
                                  num_filter=filt,
                                  name="conv%d_%d" % (i + 1, j + 1))
            net = sym.Activation(net, act_type="relu")
        net = sym.Pooling(net, pool_type="max", kernel=(2, 2),
                          stride=(2, 2), name="pool%d" % (i + 1))
    for j in range(3):
        net = sym.Convolution(net, kernel=(3, 3), pad=(1, 1),
                              num_filter=512, name="conv5_%d" % (j + 1))
        net = sym.Activation(net, act_type="relu")
    return net


def _tiny_feat(data):
    """Two-conv stride-4 backbone for tests."""
    net = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), stride=(2, 2),
                          num_filter=8, name="tc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.Convolution(net, kernel=(3, 3), pad=(1, 1), stride=(2, 2),
                          num_filter=16, name="tc2")
    return sym.Activation(net, act_type="relu")


def get_symbol_train(num_classes=21, backbone="vgg", feature_stride=16,
                     scales=(8, 16, 32), ratios=(0.5, 1, 2),
                     rpn_batch_size=256, batch_rois=128,
                     rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
                     rpn_min_size=16, pooled_size=(7, 7), hidden=1024):
    """End-to-end Faster R-CNN training symbol (batch 1, like the
    reference ``train_end2end.py``). Outputs:
    [rpn_cls_prob, rpn_bbox_loss, cls_prob, bbox_loss, BlockGrad(label)].

    Expects from the data iterator: data, im_info [1,3], gt_boxes [M,5]
    and RPN targets rpn_label [1, A*H, W] (-1 = ignore), rpn_bbox_target /
    rpn_bbox_weight [1, 4A, H, W] (see ``assign_anchors``).
    """
    data = sym.Variable("data")
    im_info = sym.Variable("im_info")
    gt_boxes = sym.Variable("gt_boxes")
    rpn_label = sym.Variable("rpn_label")
    rpn_bbox_target = sym.Variable("rpn_bbox_target")
    rpn_bbox_weight = sym.Variable("rpn_bbox_weight")

    feat = _vgg_feat(data) if backbone == "vgg" else _tiny_feat(data)
    num_anchors = len(scales) * len(ratios)

    # RPN head
    rpn_conv = sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                               num_filter=256 if backbone != "vgg" else 512,
                               name="rpn_conv_3x3")
    rpn_relu = sym.Activation(rpn_conv, act_type="relu")
    rpn_cls_score = sym.Convolution(rpn_relu, kernel=(1, 1), pad=(0, 0),
                                    num_filter=2 * num_anchors,
                                    name="rpn_cls_score")
    rpn_bbox_pred = sym.Convolution(rpn_relu, kernel=(1, 1), pad=(0, 0),
                                    num_filter=4 * num_anchors,
                                    name="rpn_bbox_pred")

    # RPN losses
    # (1, 2A, H, W) → (1, 2, A*H, W): bg/fg pair axis in front, kept 4-D
    # so the activation can be folded back to (1, 2A, H, W) for Proposal
    rpn_cls_score_reshape = sym.Reshape(rpn_cls_score, shape=(0, 2, -1, 0),
                                        name="rpn_cls_score_reshape")
    rpn_cls_prob = sym.SoftmaxOutput(rpn_cls_score_reshape, rpn_label,
                                     multi_output=True, use_ignore=True,
                                     ignore_label=-1.0,
                                     normalization="valid",
                                     name="rpn_cls_prob")
    rpn_bbox_diff = sym.broadcast_mul(
        rpn_bbox_weight, rpn_bbox_pred - rpn_bbox_target)
    rpn_bbox_loss_ = sym.smooth_l1(rpn_bbox_diff, scalar=3.0,
                                   name="rpn_bbox_loss_")
    rpn_bbox_loss = sym.MakeLoss(rpn_bbox_loss_,
                                 grad_scale=1.0 / rpn_batch_size,
                                 name="rpn_bbox_loss")

    # proposals (no gradient flows through Proposal)
    rpn_cls_act = sym.SoftmaxActivation(rpn_cls_score_reshape,
                                        mode="channel",
                                        name="rpn_cls_act")
    rpn_cls_act_reshape = sym.Reshape(rpn_cls_act,
                                      shape=(0, 2 * num_anchors, -1, 0),
                                      name="rpn_cls_act_reshape")
    rois = contrib_sym.Proposal(
        sym.BlockGrad(rpn_cls_act_reshape), sym.BlockGrad(rpn_bbox_pred),
        im_info, feature_stride=feature_stride, scales=scales,
        ratios=ratios, rpn_pre_nms_top_n=rpn_pre_nms_top_n,
        rpn_post_nms_top_n=rpn_post_nms_top_n, rpn_min_size=rpn_min_size,
        name="rois")

    # sample + targets via the python CustomOp
    group = sym.Custom(rois, gt_boxes, op_type="proposal_target",
                       num_classes=num_classes, batch_rois=batch_rois,
                       name="proposal_target")
    rois_out, label, bbox_target, bbox_weight = (
        group[0], group[1], group[2], group[3])

    # Fast R-CNN head
    pool5 = sym.ROIPooling(feat, rois_out, pooled_size=pooled_size,
                           spatial_scale=1.0 / feature_stride,
                           name="roi_pool5")
    flat = sym.Flatten(pool5)
    fc6 = sym.FullyConnected(flat, num_hidden=hidden, name="fc6")
    relu6 = sym.Activation(fc6, act_type="relu")
    fc7 = sym.FullyConnected(relu6, num_hidden=hidden, name="fc7")
    relu7 = sym.Activation(fc7, act_type="relu")
    cls_score = sym.FullyConnected(relu7, num_hidden=num_classes,
                                   name="cls_score")
    cls_prob = sym.SoftmaxOutput(cls_score, label,
                                 normalization="batch", name="cls_prob")
    bbox_pred = sym.FullyConnected(relu7, num_hidden=4 * num_classes,
                                   name="bbox_pred")
    bbox_diff = bbox_weight * (bbox_pred - bbox_target)
    bbox_loss_ = sym.smooth_l1(bbox_diff, scalar=1.0, name="bbox_loss_")
    bbox_loss = sym.MakeLoss(bbox_loss_, grad_scale=1.0 / batch_rois,
                             name="bbox_loss")
    return sym.Group([rpn_cls_prob, rpn_bbox_loss, cls_prob, bbox_loss,
                      sym.BlockGrad(label)])


# --------------------------------------------------------------------------
# AnchorLoader equivalent: RPN target assignment on the host
# --------------------------------------------------------------------------

def generate_anchors(base_size, scales, ratios):
    """Base anchors centered on a base_size cell (numpy), from the
    generator the ``Proposal`` operator uses (``contrib/ops.py``), so the
    host's RPN targets and the graph's proposals enumerate the same
    anchors."""
    from ..contrib.ops import _generate_base_anchors
    return _generate_base_anchors(base_size, scales, ratios)


def assign_anchors(gt_boxes, feat_shape, im_shape, feature_stride=16,
                   scales=(8, 16, 32), ratios=(0.5, 1, 2),
                   batch_size=256, fg_fraction=0.5, fg_overlap=0.7,
                   bg_overlap=0.3):
    """Compute RPN training targets for one image (the host-side job the
    reference does in AnchorLoader, ``rcnn/core/loader.py``). Returns
    (rpn_label [1, A*H, W], rpn_bbox_target [1, 4A, H, W],
    rpn_bbox_weight [1, 4A, H, W])."""
    H, W = feat_shape
    base = generate_anchors(feature_stride, scales, ratios)
    A = len(base)
    sx = np.arange(W) * feature_stride
    sy = np.arange(H) * feature_stride
    sxg, syg = np.meshgrid(sx, sy)
    shifts = np.stack([sxg.ravel(), syg.ravel(),
                       sxg.ravel(), syg.ravel()], axis=-1)
    anchors = (base[None] + shifts[:, None]).reshape(-1, 4)  # [HW*A, 4]
    n = len(anchors)
    labels = -np.ones((n,), np.float32)
    targets = np.zeros((n, 4), np.float32)
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < im_shape[1])
              & (anchors[:, 3] < im_shape[0]))
    gt = gt_boxes[gt_boxes[:, 4] >= 0] if len(gt_boxes) else gt_boxes
    if len(gt):
        iou = _np_iou(anchors, gt[:, :4])
        max_iou = iou.max(axis=1)
        argmax = iou.argmax(axis=1)
        labels[inside & (max_iou < bg_overlap)] = 0
        labels[inside & (max_iou >= fg_overlap)] = 1
        # best INSIDE anchor per gt is always fg (the reference's
        # AnchorLoader only ever assigns labels to inside anchors)
        if inside.any():
            iou_inside = np.where(inside[:, None], iou, -1.0)
            best = iou_inside.argmax(axis=0)
            labels[best[iou_inside.max(axis=0) > 0]] = 1
        fg = np.where(labels == 1)[0]
        max_fg = int(batch_size * fg_fraction)
        if len(fg) > max_fg:
            labels[np.random.choice(fg, len(fg) - max_fg, False)] = -1
        bg = np.where(labels == 0)[0]
        max_bg = batch_size - int((labels == 1).sum())
        if len(bg) > max_bg:
            labels[np.random.choice(bg, len(bg) - max_bg, False)] = -1
        fg = np.where(labels == 1)[0]
        targets[fg] = _bbox_transform(anchors[fg], gt[argmax[fg], :4])
    else:
        labels[inside] = 0

    # [HW*A] → the (1, A*H*W) / (1, 4A, H, W) layouts the symbol expects
    # (anchor-major per spatial position, matching rpn_cls_score_reshape)
    lab = labels.reshape(H, W, A).transpose(2, 0, 1).reshape(1, A * H, W)
    tgt = targets.reshape(H, W, A * 4).transpose(2, 0, 1)[None]
    fg_mask = (labels == 1).reshape(H, W, A)
    wgt_hw = np.repeat(fg_mask[:, :, :, None], 4, axis=3).reshape(
        H, W, 4 * A).transpose(2, 0, 1)[None]
    wgt = wgt_hw.astype(np.float32)
    return lab, tgt.astype(np.float32), wgt
