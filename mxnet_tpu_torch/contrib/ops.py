"""Contrib operators of the port (counterpart of
``mxnet_tpu/contrib/ops.py``): the detection operators of SSD and Faster
R-CNN (MultiBoxPrior, MultiBoxTarget, MultiBoxDetection, Proposal,
ROIPooling), CTCLoss, fft / ifft, quantize / dequantize, count_sketch and
``SwitchMoE``, under the JAX names, aliases, defaults and shape inference.

Each keeps the JAX function, with three rules of its own:

- Sorts break ties by the lower index, as ``jnp.argsort`` and
  ``jax.lax.top_k`` do: ``torch.sort(..., stable=True)`` and a slice,
  never ``torch.topk``, whose order of equal values is unspecified on CUDA.
- The greedy suppression loops of MultiBoxDetection and Proposal run as
  one launch of the NMS kernel (``ops.kernels.nms_suppress``) over a mask
  that PyTorch builds from ``kernels.box_iou``, one image at a time.
- ROIPooling takes each bin's maximum over a window gathered from the
  feature map, never the JAX formulation's mask over the whole map per
  bin, and ``amax`` splits the gradient among tied maxima as JAX's ``max``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ops import kernels
from ..ops.registry import OpDef, register
from ..ops.utils import as_tuple


def _parse_floats(v, default):
    if v is None:
        return list(default)
    if isinstance(v, (int, float)):
        return [float(v)]
    return [float(x) for x in v]


def _zero(like):
    return torch.zeros((), dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------------
# MultiBoxPrior: anchor box generation
# --------------------------------------------------------------------------
def _multibox_prior(attrs, ins, is_train):
    """The anchors of a feature map [1, h*w*A, 4]. The JAX package computes
    them in f64 (its arange and lists under x64); the port does too and
    returns them in f32 (or f64 for f64 data): bf16 data under AMP does not
    round the anchors the matching reads."""
    data = ins[0]
    sizes = _parse_floats(attrs.get("sizes"), (1.0,))
    ratios = _parse_floats(attrs.get("ratios"), (1.0,))
    steps = _parse_floats(attrs.get("steps"), (-1.0, -1.0))
    offsets = _parse_floats(attrs.get("offsets"), (0.5, 0.5))
    h, w = data.shape[2], data.shape[3]
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if len(steps) > 1 and steps[1] > 0 else 1.0 / w
    num_anchors = len(sizes) + len(ratios) - 1
    f64 = dict(dtype=torch.float64, device=data.device)
    cy = (torch.arange(h, **f64) + offsets[0]) * step_y
    cx = (torch.arange(w, **f64) + offsets[1]) * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    ws, hs = [], []
    for i in range(num_anchors):
        if i < len(sizes):
            s, r = sizes[i], ratios[0]
        else:
            s, r = sizes[0], ratios[i - len(sizes) + 1]
        sr = np.sqrt(r)
        ws.append(s * sr / 2.0)
        hs.append(s / sr / 2.0)
    # the sizes stay Python numbers: no host-to-device copy, so a captured
    # graph can hold the operator
    boxes = torch.stack([torch.stack([cxg - w_, cyg - h_, cxg + w_, cyg + h_], dim=-1)
                         for w_, h_ in zip(ws, hs)], dim=2)  # [h,w,A,4]
    return [boxes.reshape(1, -1, 4).to(torch.promote_types(data.dtype, torch.float32))]


def _multibox_prior_infer(attrs, in_shapes):
    d = in_shapes[0]
    sizes = _parse_floats(attrs.get("sizes"), (1.0,))
    ratios = _parse_floats(attrs.get("ratios"), (1.0,))
    num_anchors = len(sizes) + len(ratios) - 1
    return [tuple(d)], [(1, d[2] * d[3] * num_anchors, 4)], []


register(
    OpDef(
        "_contrib_MultiBoxPrior",
        _multibox_prior,
        arguments=("data",),
        defaults={"sizes": (1.0,), "ratios": (1.0,), "clip": False,
                  "steps": (-1.0, -1.0), "offsets": (0.5, 0.5)},
        infer_shape=_multibox_prior_infer,
        aliases=("MultiBoxPrior",),
    )
)


# --------------------------------------------------------------------------
# MultiBoxTarget: anchor -> ground-truth matching + target encoding
# --------------------------------------------------------------------------
def _last_write(index, values, size):
    """``zeros(size).at[index].set(values)`` with JAX's CPU rule for
    repeated indices, the last write wins, on any device: for each slot the
    value of the last position of ``index`` that names it, else False.
    ``index`` [B, M], ``values`` bool [B, M] -> bool [B, size]."""
    m = index.shape[-1]
    hit = index[:, None, :] == torch.arange(size, device=index.device)[None, :, None]  # [B,A,M]
    pos = torch.arange(m, device=index.device)
    last = torch.where(hit, pos, torch.full_like(pos, -1)).amax(dim=2)  # [B, A]
    picked = torch.gather(values, 1, last.clamp(min=0))
    return (last >= 0) & picked


def _multibox_target(attrs, ins, is_train):
    anchors, labels, _ = ins
    overlap_thresh = float(attrs.get("overlap_threshold", 0.5))
    variances = _parse_floats(attrs.get("variances"), (0.1, 0.1, 0.2, 0.2))
    anc = anchors[0]  # [A,4]
    a_n = anc.shape[0]
    b_n = labels.shape[0]
    valid = labels[:, :, 0] >= 0  # [B, M]: cls < 0 pads
    gt = labels[:, :, 1:5]
    ious = torch.stack([kernels.box_iou(anc, gt[b]) for b in range(b_n)])  # [B,A,M]
    ious = ious * valid[:, None, :].to(ious.dtype)
    best_iou, best_gt = ious.max(dim=2)  # argmax: the first of equal values, as JAX
    match = best_iou > overlap_thresh
    # force-match the best anchor of each gt. A padding row has no overlap,
    # so its best anchor is anchor 0 and it writes False there: the JAX
    # package's scatter keeps the last write of a repeated index, and so
    # does this one
    best_anchor = ious.argmax(dim=1)  # [B, M]
    match = match | _last_write(best_anchor, valid, a_n)
    cls_of = torch.gather(labels[:, :, 0], 1, best_gt)
    cls_target = torch.where(match, cls_of + 1.0, _zero(cls_of))
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    aw = torch.clamp(anc[:, 2] - anc[:, 0], min=1e-8)
    ah = torch.clamp(anc[:, 3] - anc[:, 1], min=1e-8)
    g = torch.gather(gt, 1, best_gt[..., None].expand(b_n, a_n, 4))  # [B, A, 4]
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    gw = torch.clamp(g[..., 2] - g[..., 0], min=1e-8)
    gh = torch.clamp(g[..., 3] - g[..., 1], min=1e-8)
    tx = (gcx - acx) / aw / variances[0]
    ty = (gcy - acy) / ah / variances[1]
    tw = torch.log(gw / aw) / variances[2]
    th = torch.log(gh / ah) / variances[3]
    loc_target = torch.stack([tx, ty, tw, th], dim=-1)  # [B, A, 4]
    loc_mask = match[..., None].to(loc_target.dtype).expand(b_n, a_n, 4)
    loc_target = loc_target * loc_mask
    return [loc_target.reshape(b_n, -1), loc_mask.reshape(b_n, -1).contiguous(), cls_target]


def _multibox_target_infer(attrs, in_shapes):
    anc, lab, cls = in_shapes
    return (
        [tuple(anc), tuple(lab), tuple(cls)],
        [(lab[0], anc[1] * 4), (lab[0], anc[1] * 4), (lab[0], anc[1])],
        [],
    )


register(
    OpDef(
        "_contrib_MultiBoxTarget",
        _multibox_target,
        arguments=("anchor", "label", "cls_pred"),
        outputs=("loc_target", "loc_mask", "cls_target"),
        defaults={
            "overlap_threshold": 0.5, "ignore_label": -1.0,
            "negative_mining_ratio": -1.0, "negative_mining_thresh": 0.5,
            "minimum_negative_samples": 0,
            "variances": (0.1, 0.1, 0.2, 0.2),
        },
        infer_shape=_multibox_target_infer,
        need_top_grad=False,
        aliases=("MultiBoxTarget",),
    )
)


# --------------------------------------------------------------------------
# MultiBoxDetection: decode + NMS
# --------------------------------------------------------------------------
def detection_nms_inputs(boxes, cls_id, order, nms_threshold):
    """The NMS kernel's (mask, order, active) for MultiBoxDetection's loop
    (``mxnet_tpu/contrib/ops.py:233-247``): step s visits box ``order[b, s]``
    and, when that box has a class (>= 0) and is not suppressed, suppresses
    every box of its class, at any index but its own, whose IoU with it
    exceeds the threshold. ``boxes`` [B, A, 4], ``cls_id`` [B, A],
    ``order`` [B, S]. The mask is built one image at a time."""
    b_n, a_n = cls_id.shape
    cols = torch.arange(a_n, device=boxes.device)
    rows = []
    for b in range(b_n):
        idx = order[b]
        iou = kernels.box_iou(boxes[b][idx], boxes[b])  # [S, A], rows of the full matrix
        same = cls_id[b][None, :] == cls_id[b][idx][:, None]
        rows.append((iou > nms_threshold) & same & (cols[None, :] != idx[:, None]))
    return torch.stack(rows), order, cls_id >= 0


def detection_candidates(attrs, cls_prob, loc_pred, anchors):
    """MultiBoxDetection's boxes before suppression: (boxes [B, A, 4] decoded
    and clipped, cls_id [B, A] (-1 at or under ``threshold``), score [B,
    A], order [B, A], the score order with ties by the lower index).
    ``attrs`` canonical, as an fcompute's."""
    threshold = float(attrs.get("threshold", 0.01))
    variances = _parse_floats(attrs.get("variances"), (0.1, 0.1, 0.2, 0.2))
    clip = bool(attrs.get("clip", True))
    anc = anchors[0]
    a_n = anc.shape[0]
    b_n = cls_prob.shape[0]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    locs = loc_pred.reshape(b_n, a_n, 4)
    cx = locs[..., 0] * variances[0] * aw + acx
    cy = locs[..., 1] * variances[1] * ah + acy
    w = torch.exp(locs[..., 2] * variances[2]) * aw / 2
    h = torch.exp(locs[..., 3] * variances[3]) * ah / 2
    boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)  # [B, A, 4]
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    score, cls_idx = cls_prob[:, 1:].max(dim=1)  # the first of equal values, as JAX
    cls_id = torch.where(score > threshold, cls_idx.to(cls_prob.dtype),
                         torch.full_like(score, -1.0))
    order = torch.argsort(-score, dim=1, stable=True)  # jnp.argsort(-score)
    return boxes, cls_id, score, order


def _multibox_detection(attrs, ins, is_train):
    cls_prob, loc_pred, anchors = ins
    nms_threshold = float(attrs.get("nms_threshold", 0.5))
    nms_topk = int(attrs.get("nms_topk", -1))
    boxes, cls_id, score, order = detection_candidates(attrs, cls_prob, loc_pred, anchors)
    a_n = boxes.shape[1]
    max_iter = a_n if nms_topk <= 0 else min(nms_topk, a_n)
    mask, order, active = detection_nms_inputs(boxes, cls_id, order[:, :max_iter],
                                               nms_threshold)
    suppressed = kernels.nms_suppress(mask, order, active)
    final_id = torch.where(suppressed, torch.full_like(cls_id, -1.0), cls_id)
    return [torch.stack([final_id, score, boxes[..., 0], boxes[..., 1], boxes[..., 2],
                         boxes[..., 3]], dim=-1)]


def _multibox_detection_infer(attrs, in_shapes):
    cls, loc, anc = in_shapes
    return [tuple(cls), tuple(loc), tuple(anc)], [(cls[0], anc[1], 6)], []


register(
    OpDef(
        "_contrib_MultiBoxDetection",
        _multibox_detection,
        arguments=("cls_prob", "loc_pred", "anchor"),
        defaults={
            "clip": True, "threshold": 0.01, "background_id": 0,
            "nms_threshold": 0.5, "force_suppress": False,
            "variances": (0.1, 0.1, 0.2, 0.2), "nms_topk": -1,
        },
        infer_shape=_multibox_detection_infer,
        need_top_grad=False,
        aliases=("MultiBoxDetection",),
    )
)


# --------------------------------------------------------------------------
# Proposal (Faster R-CNN RPN proposals)
# --------------------------------------------------------------------------
def _generate_base_anchors(base_size, scales, ratios):
    base = np.array([0, 0, base_size - 1, base_size - 1], np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    anchors = []
    for r in ratios:
        size = w * h
        size_ratio = size / r
        ws = int(round(np.sqrt(size_ratio)))
        hs = int(round(ws * r))
        for s in scales:
            wss = ws * s
            hss = hs * s
            anchors.append(
                [cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                 cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)]
            )
    return np.array(anchors, np.float32)


def proposal_nms_inputs(top_boxes, top_scores, nms_thresh):
    """The NMS kernel's (mask, order, active) for Proposal's loop
    (``mxnet_tpu/contrib/ops.py:368-379``): step i visits the i-th box of
    the score order and, when it scores above 0 and is not suppressed,
    suppresses the boxes after it whose IoU with it exceeds the threshold.
    ``top_boxes`` [k, 4], ``top_scores`` [k]; one sample."""
    k = top_boxes.shape[0]
    pos = torch.arange(k, device=top_boxes.device)
    mask = (kernels.box_iou(top_boxes, top_boxes) > nms_thresh) & (pos[None, :] > pos[:, None])
    return mask[None], pos[None], (top_scores > 0)[None]


def proposal_candidates(attrs, cls_prob, bbox_pred, im_info):
    """Proposal's boxes before suppression: every anchor decoded and clipped
    to the image, and its foreground score (-1 under ``rpn_min_size``), in
    the score order, cut to ``rpn_pre_nms_top_n``: (top_boxes [k, 4],
    top_scores [k]). ``attrs`` canonical, as an fcompute's."""
    feature_stride = int(attrs.get("feature_stride", 16))
    scales = _parse_floats(attrs.get("scales"), (4.0, 8.0, 16.0, 32.0))
    ratios = _parse_floats(attrs.get("ratios"), (0.5, 1.0, 2.0))
    rpn_pre_nms_top_n = int(attrs.get("rpn_pre_nms_top_n", 6000))
    min_size = float(attrs.get("rpn_min_size", 16))
    dev = cls_prob.device

    base_anchors = _generate_base_anchors(feature_stride, scales, ratios)  # [A, 4] f32
    a_n = base_anchors.shape[0]
    h_n, w_n = cls_prob.shape[2], cls_prob.shape[3]
    shift_x = torch.arange(w_n, device=dev) * feature_stride
    shift_y = torch.arange(h_n, device=dev) * feature_stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    sx, sy = sx.reshape(-1), sy.reshape(-1)
    # integer shifts plus each f32 base anchor's corners, kept as Python
    # numbers (no host-to-device copy): [HW, A, 4] -> [HW*A, 4] f32
    anchors = torch.stack([
        torch.stack([sx + float(a[0]), sy + float(a[1]), sx + float(a[2]), sy + float(a[3])],
                    dim=-1) for a in base_anchors], dim=1).reshape(-1, 4)

    scores = cls_prob[0, a_n:].permute(1, 2, 0).reshape(-1)  # fg scores
    deltas = bbox_pred[0].permute(1, 2, 0).reshape(-1, 4)
    widths = anchors[:, 2] - anchors[:, 0] + 1.0
    heights = anchors[:, 3] - anchors[:, 1] + 1.0
    ctr_x = anchors[:, 0] + 0.5 * (widths - 1.0)
    ctr_y = anchors[:, 1] + 0.5 * (heights - 1.0)
    pred_ctr_x = deltas[:, 0] * widths + ctr_x
    pred_ctr_y = deltas[:, 1] * heights + ctr_y
    pred_w = torch.exp(deltas[:, 2]) * widths
    pred_h = torch.exp(deltas[:, 3]) * heights
    x1 = pred_ctr_x - 0.5 * (pred_w - 1)
    y1 = pred_ctr_y - 0.5 * (pred_h - 1)
    x2 = pred_ctr_x + 0.5 * (pred_w - 1)
    y2 = pred_ctr_y + 0.5 * (pred_h - 1)
    im_h, im_w = im_info[0, 0], im_info[0, 1]
    zero = _zero(x1)
    boxes = torch.stack([
        torch.minimum(torch.maximum(x1, zero), im_w - 1),
        torch.minimum(torch.maximum(y1, zero), im_h - 1),
        torch.minimum(torch.maximum(x2, zero), im_w - 1),
        torch.minimum(torch.maximum(y2, zero), im_h - 1),
    ], dim=-1)
    ws = boxes[:, 2] - boxes[:, 0] + 1
    hs = boxes[:, 3] - boxes[:, 1] + 1
    valid = (ws >= min_size) & (hs >= min_size)
    scores = torch.where(valid, scores, torch.full_like(scores, -1.0))

    k = min(rpn_pre_nms_top_n, scores.shape[0])
    # jax.lax.top_k: descending, the lower index first among equal scores
    top_scores, top_idx = torch.sort(scores, descending=True, stable=True)
    return boxes[top_idx[:k]], top_scores[:k]


def _proposal(attrs, ins, is_train):
    cls_prob, bbox_pred, im_info = ins
    rpn_post_nms_top_n = int(attrs.get("rpn_post_nms_top_n", 300))
    nms_thresh = float(attrs.get("threshold", 0.7))
    dev, dt = cls_prob.device, cls_prob.dtype
    top_boxes, top_scores = proposal_candidates(attrs, cls_prob, bbox_pred, im_info)
    k = top_boxes.shape[0]
    suppressed = kernels.nms_suppress(*proposal_nms_inputs(top_boxes, top_scores,
                                                           nms_thresh))[0]
    keep_score = torch.where(suppressed, torch.full_like(top_scores, -1.0), top_scores)
    n_out = min(rpn_post_nms_top_n, k)
    final_scores, final_idx = torch.sort(keep_score, descending=True, stable=True)
    final_scores, final_idx = final_scores[:n_out], final_idx[:n_out]
    final_boxes = top_boxes[final_idx]
    rois = torch.cat([torch.zeros((n_out, 1), dtype=dt, device=dev), final_boxes.to(dt)],
                     dim=-1)
    if bool(attrs.get("output_score", False)):
        return [rois, final_scores[:, None]]
    return [rois]


def _proposal_infer(attrs, in_shapes):
    rpn_post = int(attrs.get("rpn_post_nms_top_n", 300))
    pre = int(attrs.get("rpn_pre_nms_top_n", 6000))
    outs = [(min(rpn_post, pre), 5)]
    if bool(attrs.get("output_score", False)):
        outs.append((min(rpn_post, pre), 1))
    return [tuple(s) for s in in_shapes], outs, []


_proposal_def = OpDef(
    "_contrib_Proposal",
    _proposal,
    arguments=("cls_prob", "bbox_pred", "im_info"),
    defaults={
        "rpn_pre_nms_top_n": 6000, "rpn_post_nms_top_n": 300,
        "threshold": 0.7, "rpn_min_size": 16,
        "scales": (4.0, 8.0, 16.0, 32.0), "ratios": (0.5, 1.0, 2.0),
        "feature_stride": 16, "output_score": False, "iou_loss": False,
    },
    infer_shape=_proposal_infer,
    need_top_grad=False,
    aliases=("Proposal",),
)
_proposal_def.list_outputs = lambda attrs=None: (
    ["output", "score"] if (attrs or {}).get("output_score") else ["output"]
)
register(_proposal_def)


# --------------------------------------------------------------------------
# ROIPooling
# --------------------------------------------------------------------------
def _roi_bins(rois, spatial_scale, pooled, size):
    """Each roi's bins along one axis, clipped to [0, size): (start, length)
    [R, pooled] int64, as the JAX package's ``pool_cell`` bounds
    (``mxnet_tpu/contrib/ops.py:446-449``; ``jnp.round`` and
    ``torch.round`` both round half to even)."""
    lo = torch.round(rois[:, 0] * spatial_scale).to(torch.int32).to(torch.int64)
    hi = torch.round(rois[:, 1] * spatial_scale).to(torch.int32).to(torch.int64)
    extent = torch.clamp(hi - lo + 1, min=1)[:, None]
    p = torch.arange(pooled, device=rois.device)[None, :]
    start = lo[:, None] + (p * extent) // pooled
    end = lo[:, None] + ((p + 1) * extent + pooled - 1) // pooled
    start = torch.clamp(start, 0, size)
    end = torch.clamp(end, 0, size)
    return start, torch.clamp(end - start, min=0)


def _roi_pooling(attrs, ins, is_train):
    """Each bin's maximum over a window of the feature map gathered at the
    bin: the windows are as large as the largest clipped bin, read from the
    rois on the host (so a CUDA graph cannot hold this operator:
    ``operator.refuse_capture``), and the positions outside a bin read -inf.
    An empty bin gives 0, as in JAX."""
    data, rois = ins
    pooled_h, pooled_w = as_tuple(attrs["pooled_size"], 2, "pooled_size")
    spatial_scale = float(attrs.get("spatial_scale", 1.0))
    n_n, c_n, h_n, w_n = data.shape
    r_n = rois.shape[0]
    dev = data.device
    # an image index out of range reads the nearest image, as JAX's gather
    bidx = rois[:, 0].to(torch.int32).to(torch.int64).clamp(0, n_n - 1)
    hs, hl = _roi_bins(rois[:, [2, 4]], spatial_scale, pooled_h, h_n)  # [R, ph]
    ws, wl = _roi_bins(rois[:, [1, 3]], spatial_scale, pooled_w, w_n)  # [R, pw]
    hb, wb = max(int(hl.max()), 1), max(int(wl.max()), 1)
    dh = torch.arange(hb, device=dev)
    dw = torch.arange(wb, device=dev)
    rows = hs[:, :, None] + dh  # [R, ph, hb]
    cols = ws[:, :, None] + dw  # [R, pw, wb]
    inside = ((dh < hl[:, :, None])[:, :, None, :, None]
              & (dw < wl[:, :, None])[:, None, :, None, :])  # [R, ph, pw, hb, wb]
    flat = (bidx[:, None, None, None, None] * (h_n * w_n)
            + rows.clamp(max=h_n - 1)[:, :, None, :, None] * w_n
            + cols.clamp(max=w_n - 1)[:, None, :, None, :])
    table = data.permute(0, 2, 3, 1).reshape(n_n * h_n * w_n, c_n)  # channels last
    win = table[flat.reshape(-1)].reshape(r_n, pooled_h, pooled_w, hb * wb, c_n)
    win = torch.where(inside.reshape(r_n, pooled_h, pooled_w, hb * wb, 1), win,
                      torch.full((), float("-inf"), dtype=data.dtype, device=dev))
    val = win.amax(dim=3)  # [R, ph, pw, C]
    val = torch.where(torch.isfinite(val), val, _zero(val))
    return [val.permute(0, 3, 1, 2).contiguous()]


def _roi_pooling_infer(attrs, in_shapes):
    d, r = in_shapes
    ph, pw = as_tuple(attrs["pooled_size"], 2, "pooled_size")
    return [tuple(d), tuple(r)], [(r[0], d[1], ph, pw)], []


register(
    OpDef(
        "ROIPooling",
        _roi_pooling,
        arguments=("data", "rois"),
        defaults={"pooled_size": (7, 7), "spatial_scale": 1.0},
        infer_shape=_roi_pooling_infer,
    )
)


# --------------------------------------------------------------------------
# CTCLoss: the log-space forward recursion over the blank-extended label,
# a loop over T under autograd (JAX's lax.scan). Blank 0; 0-entries of the
# label matrix pad; -1e30 stands for log 0; a sample with a label outside
# [0, alphabet) gets +inf.
# --------------------------------------------------------------------------
def _ctc_loss(attrs, ins, is_train):
    data, label = ins  # [T, B, C] activations, [B, L] labels
    t_len, b_n, c_n = data.shape
    l_max = label.shape[1]
    s_n = 2 * l_max + 1
    dev = data.device
    logp = torch.log_softmax(data.float(), dim=-1)
    label = label.to(torch.int32).to(torch.int64)
    oob_sample = ((label < 0) | (label >= c_n)).any(dim=1)
    label = label.clamp(0, c_n - 1)
    neg_inf = torch.full((), -1e30, dtype=torch.float32, device=dev)

    ext = torch.zeros((b_n, s_n), dtype=torch.int64, device=dev)
    ext[:, 1::2] = label
    label_len = (label > 0).sum(dim=1)
    ext_len = 2 * label_len + 1
    ext_prev2 = F.pad(ext, (2, 0))[:, :s_n]
    can_skip = (ext != 0) & (ext != ext_prev2)
    pos = torch.arange(s_n, device=dev)[None, :]
    valid = pos < ext_len[:, None]

    alpha = neg_inf.expand(b_n, max(s_n, 2)).clone()
    alpha[:, 0] = logp[0, :, 0]
    if l_max:
        alpha[:, 1] = torch.where(label_len > 0, torch.gather(logp[0], 1, label[:, :1])[:, 0],
                                  neg_inf)
    alpha = torch.where(valid, alpha[:, :s_n], neg_inf)
    for t in range(1, t_len):
        a_prev1 = F.pad(alpha, (1, 0), value=-1e30)[:, :s_n]
        a_prev2 = F.pad(alpha, (2, 0), value=-1e30)[:, :s_n]
        a_prev2 = torch.where(can_skip, a_prev2, neg_inf)
        merged = torch.logsumexp(torch.stack([alpha, a_prev1, a_prev2]), dim=0)
        alpha = torch.where(valid, merged + torch.gather(logp[t], 1, ext), neg_inf)

    idx_last = (ext_len - 1).clamp(0, s_n - 1)
    idx_prev = (ext_len - 2).clamp(0, s_n - 1)
    a_last = torch.gather(alpha, 1, idx_last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, idx_prev[:, None])[:, 0]
    a_prev = torch.where(label_len > 0, a_prev, neg_inf)
    loss = -torch.logsumexp(torch.stack([a_last, a_prev]), dim=0)
    loss = torch.where(oob_sample, torch.full_like(loss, float("inf")), loss)
    return [loss.to(data.dtype)]


def _ctc_loss_infer(attrs, in_shapes):
    dshape, lshape = in_shapes
    if dshape is None:
        raise MXNetError("CTCLoss: data shape required")
    if len(dshape) != 3:
        raise MXNetError("CTCLoss: data must be [seq_len, batch, alphabet]")
    if lshape is None:
        raise MXNetError("CTCLoss: label shape required")
    return [tuple(dshape), tuple(lshape)], [(dshape[1],)], []


register(
    OpDef(
        "CTCLoss",
        _ctc_loss,
        arguments=("data", "label"),
        infer_shape=_ctc_loss_infer,
        aliases=("ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss"),
    )
)


# --------------------------------------------------------------------------
# fft / ifft (cuFFT C2C in the reference): the output interleaves real and
# imaginary parts along the last axis; ifft is unnormalised, so
# ifft(fft(x)) == n * x
# --------------------------------------------------------------------------
def _fft(attrs, ins, is_train):
    x = ins[0]
    spec = torch.fft.fft(x.to(torch.complex64), dim=-1)
    out = torch.stack([spec.real, spec.imag], dim=-1)
    return [out.reshape(x.shape[:-1] + (2 * x.shape[-1],)).float()]


def _ifft(attrs, ins, is_train):
    x = ins[0]
    d = x.shape[-1] // 2
    inter = x.reshape(x.shape[:-1] + (d, 2)).float()
    spec = torch.complex(inter[..., 0], inter[..., 1])
    return [torch.fft.ifft(spec, dim=-1, norm="forward").real.float()]


register(
    OpDef(
        "fft",
        _fft,
        arguments=("data",),
        defaults={"compute_size": 128},
        infer_shape=lambda attrs, ins: (
            [tuple(ins[0])], [tuple(ins[0][:-1]) + (2 * ins[0][-1],)], []),
        aliases=("_contrib_fft",),
    )
)
register(
    OpDef(
        "ifft",
        _ifft,
        arguments=("data",),
        defaults={"compute_size": 128},
        infer_shape=lambda attrs, ins: (
            [tuple(ins[0])], [tuple(ins[0][:-1]) + (ins[0][-1] // 2,)], []),
        aliases=("_contrib_ifft",),
    )
)


# --------------------------------------------------------------------------
# quantize / dequantize: [min_range, max_range] onto the uint8 range and back
# --------------------------------------------------------------------------
def _quantize(attrs, ins, is_train):
    data, min_r, max_r = ins
    lo = min_r.min()
    hi = max_r.max()
    scale = 255.0 / torch.clamp(hi - lo, min=1e-8)
    q = torch.clamp(torch.round((data - lo) * scale), 0, 255).to(torch.uint8)
    return [q, lo.reshape(1), hi.reshape(1)]


def _dequantize(attrs, ins, is_train):
    data, min_r, max_r = ins
    lo = min_r.min()
    hi = max_r.max()
    scale = torch.clamp(hi - lo, min=1e-8) / 255.0
    return [data.float() * scale + lo]


def _quantize_infer(attrs, in_shapes):
    d = in_shapes[0]
    return [tuple(d), (1,), (1,)], [tuple(d), (1,), (1,)], []


register(
    OpDef(
        "quantize",
        _quantize,
        arguments=("data", "min_range", "max_range"),
        outputs=("output", "min_output", "max_output"),
        infer_shape=_quantize_infer,
        infer_type=lambda attrs, in_types: (
            [np.float32, np.float32, np.float32], [np.uint8, np.float32, np.float32], []),
        aliases=("_contrib_quantize",),
    )
)
register(
    OpDef(
        "dequantize",
        _dequantize,
        arguments=("data", "min_range", "max_range"),
        infer_shape=lambda attrs, ins: ([tuple(ins[0]), (1,), (1,)], [tuple(ins[0])], []),
        infer_type=lambda attrs, in_types: (
            [np.uint8, np.float32, np.float32], [np.float32], []),
        aliases=("_contrib_dequantize",),
    )
)


# --------------------------------------------------------------------------
# count_sketch (compact bilinear pooling): out[n, h[i]] += s[i] * data[n, i]
# --------------------------------------------------------------------------
def _count_sketch_dim(attrs):
    out_dim = int(attrs.get("out_dim", 0))
    if out_dim <= 0:
        raise MXNetError("count_sketch: out_dim is required and must be > 0")
    return out_dim


def _count_sketch(attrs, ins, is_train):
    data, h, sgn = ins
    out_dim = _count_sketch_dim(attrs)
    idx = h.reshape(-1).to(torch.int32).to(torch.int64)
    signs = sgn.reshape(-1).to(data.dtype)
    out = torch.zeros(data.shape[:-1] + (out_dim,), dtype=data.dtype, device=data.device)
    return [out.index_add(data.dim() - 1, idx, data * signs)]


def _count_sketch_infer(attrs, in_shapes):
    d = in_shapes[0]
    out_dim = _count_sketch_dim(attrs)
    in_dim = d[-1]
    return [tuple(d), (1, in_dim), (1, in_dim)], [tuple(d[:-1]) + (out_dim,)], []


register(
    OpDef(
        "count_sketch",
        _count_sketch,
        arguments=("data", "h", "s"),
        defaults={"out_dim": 0, "processing_batch_size": 32},
        infer_shape=_count_sketch_infer,
        aliases=("_contrib_count_sketch",),
    )
)


# --------------------------------------------------------------------------
# SwitchMoE: top-1 mixture-of-experts FFN as a Symbol operator
# --------------------------------------------------------------------------
def _switch_moe(attrs, ins, is_train):
    """Two outputs: the routed FFN's result [tokens, d_model] and the
    load-balance aux loss as a [1] tensor (add it to the objective through
    MakeLoss)."""
    from ..parallel.moe import switch_moe

    data, gate_w, w_up, w_down = ins
    y, aux = switch_moe({"gate_w": gate_w, "w_up": w_up, "w_down": w_down}, data,
                        capacity_factor=float(attrs.get("capacity_factor", 1.25)))
    return [y, aux.reshape(1)]


def _switch_moe_infer(attrs, in_shapes):
    data, _, _, _ = in_shapes
    if data is None:
        raise MXNetError("SwitchMoE: data shape required")  # resolvable later
    if len(data) != 2:
        # ValueError: a known but wrong rank must survive the inference
        # fixpoint loop, which takes MXNetError as "not resolvable yet"
        raise ValueError("SwitchMoE: data must be [tokens, d_model] "
                         "(Reshape (B,T,D) inputs to (B*T, D))")
    d_model = data[1]
    num_experts = int(attrs["num_experts"])
    d_hidden = int(attrs["num_hidden"])
    if d_hidden <= 0:
        # a 0 width would infer empty expert weights and train the MoE
        # branch as a no-op
        raise ValueError("SwitchMoE: num_hidden must be set (> 0)")
    return (
        [tuple(data), (d_model, num_experts),
         (num_experts, d_model, d_hidden), (num_experts, d_hidden, d_model)],
        [tuple(data), (1,)],
        [],
    )


register(
    OpDef(
        "_contrib_SwitchMoE",
        _switch_moe,
        arguments=("data", "gate_weight", "up_weight", "down_weight"),
        outputs=("output", "aux_loss"),
        defaults={"num_experts": 8, "num_hidden": 0, "capacity_factor": 1.25},
        infer_shape=_switch_moe_infer,
        aliases=("SwitchMoE",),
    )
)


# The names contrib/{symbol,ndarray}.py expose
CONTRIB_OP_EXPORTS = (
    "MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection", "Proposal",
    "ROIPooling", "CTCLoss", "ctc_loss", "fft", "ifft", "quantize",
    "dequantize", "count_sketch", "SwitchMoE",
)
