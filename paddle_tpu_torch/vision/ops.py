"""Vision ops: box areas and IoU, NMS, RoI align and the YOLO head's
decode and loss — the port of `paddle_tpu/vision/ops.py`.

Every op runs on its inputs' device with static shapes, as the
reference: `nms` returns the kept indices padded with -1 to the number
of boxes, ordered by a stable sort of the scores, and its suppression
loop stays on the device (one masked update a box, no host sync).
"""
from __future__ import annotations

import torch


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1, boxes2):
    """[N, 4] x [M, 4] xyxy -> [N, M] IoU (union floored at 1e-9)."""
    a1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    a2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (a1[:, None] + a2[None, :] - inter).clamp_min(1e-9)


def nms(boxes, scores=None, iou_threshold=0.3, top_k=None):
    """Indices of the kept boxes in descending score order, padded with -1
    to len(boxes) (then cut to top_k), int32. Greedy: box i (in score
    order) suppresses every later box whose IoU with it exceeds the
    threshold, if i itself is kept."""
    n = boxes.shape[0]
    dev = boxes.device
    if scores is None:
        scores = torch.arange(n, 0, -1, device=dev).float()
    order = torch.argsort(-scores, stable=True)
    iou = box_iou(boxes, boxes)
    iou_sorted = iou[order][:, order]
    ar = torch.arange(n, device=dev)
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    over = iou_sorted > iou_threshold
    for i in range(n):
        keep = keep & ~(over[i] & (ar > i) & keep[i])
    kept_sorted_idx = torch.where(keep, order, torch.full_like(order, -1))
    perm = torch.argsort(torch.where(keep, ar, n + ar))
    out = kept_sorted_idx[perm]
    if top_k is not None:
        out = out[:top_k]
    return out.to(torch.int32)


def roi_align(x, boxes, boxes_num=None, output_size=7, spatial_scale=1.0,
              sampling_ratio=1, aligned=True):
    """RoI Align, one bilinear sample a bin: x NCHW, boxes [K, 4] in image
    coordinates, each on the batch item `boxes_num` maps it to (item 0
    without it) -> [K, C, oh, ow]."""
    if isinstance(output_size, int):
        oh = ow = output_size
    else:
        oh, ow = output_size
    n, c, h, w = x.shape
    k = boxes.shape[0]
    dev = x.device
    offset = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * spatial_scale - offset
    y1 = boxes[:, 1] * spatial_scale - offset
    x2 = boxes[:, 2] * spatial_scale - offset
    y2 = boxes[:, 3] * spatial_scale - offset
    floor = 1.0 if not aligned else 1e-4
    bw = (x2 - x1).clamp_min(floor)
    bh = (y2 - y1).clamp_min(floor)
    ys = y1[:, None] + (torch.arange(oh, device=dev) + 0.5)[None, :] \
        * (bh[:, None] / oh)
    xs = x1[:, None] + (torch.arange(ow, device=dev) + 0.5)[None, :] \
        * (bw[:, None] / ow)
    if boxes_num is not None:
        bn = torch.as_tensor(boxes_num, device=dev).reshape(-1).long()
        batch_idx = torch.repeat_interleave(
            torch.arange(bn.shape[0], device=dev), bn, output_size=k)
    else:
        batch_idx = torch.zeros(k, dtype=torch.int64, device=dev)
    yy = ys.clamp(0, h - 1)
    xx = xs.clamp(0, w - 1)
    y0 = torch.floor(yy).long()
    x0 = torch.floor(xx).long()
    y1i = (y0 + 1).clamp_max(h - 1)
    x1i = (x0 + 1).clamp_max(w - 1)
    wy = (yy - y0)[:, :, None, None]
    wx = (xx - x0)[:, None, :, None]
    img = x.permute(0, 2, 3, 1)  # [N, H, W, C]
    bi = batch_idx[:, None, None]

    def g(yi, xi):  # [K, oh, ow, C]
        return img[bi, yi[:, :, None], xi[:, None, :]]

    out = (g(y0, x0) * (1 - wy) * (1 - wx) + g(y1i, x0) * wy * (1 - wx)
           + g(y0, x1i) * (1 - wy) * wx + g(y1i, x1i) * wy * wx)
    return out.permute(0, 3, 1, 2)


def yolo_box_decode(pred, anchors, downsample_ratio=32, class_num=80,
                    conf_thresh=0.01):
    """The YOLO head [B, A·(5 + C), H, W] decoded to normalized xyxy
    boxes [B, A·H·W, 4] and objectness [B, A·H·W]."""
    b, _, h, w = pred.shape
    dev = pred.device
    na = len(anchors) // 2
    pred = pred.reshape(b, na, 5 + class_num, h, w)
    gx = torch.arange(w, device=dev)[None, None, None, :]
    gy = torch.arange(h, device=dev)[None, None, :, None]
    ax = torch.tensor(anchors[0::2], dtype=torch.float32,
                      device=dev).reshape(1, na, 1, 1)
    ay = torch.tensor(anchors[1::2], dtype=torch.float32,
                      device=dev).reshape(1, na, 1, 1)
    cx = (torch.sigmoid(pred[:, :, 0]) + gx) / w
    cy = (torch.sigmoid(pred[:, :, 1]) + gy) / h
    bw = torch.exp(pred[:, :, 2]) * ax / (w * downsample_ratio)
    bh = torch.exp(pred[:, :, 3]) * ay / (h * downsample_ratio)
    conf = torch.sigmoid(pred[:, :, 4])
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                         cy + bh / 2], dim=-1)
    return boxes.reshape(b, -1, 4), conf.reshape(b, -1)


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, name=None, scale_x_y=1.0):
    from ..nn.functional.detection import yolo_box as _yb
    return _yb(x, img_size, anchors, class_num, conf_thresh,
               downsample_ratio, clip_bbox, name, scale_x_y)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh=0.7, downsample_ratio=32, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    from ..nn.functional.detection import yolov3_loss
    return yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                       ignore_thresh, downsample_ratio, gt_score,
                       use_label_smooth, name, scale_x_y)


__all__ = ["box_area", "box_iou", "nms", "roi_align", "yolo_box_decode",
           "yolo_box", "yolo_loss"]
