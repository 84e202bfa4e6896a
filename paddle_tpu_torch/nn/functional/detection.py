"""The fluid-era detection ops: the port of
`paddle_tpu/nn/functional/detection.py`.

The reference's contract holds: every op keeps static shapes — top-k by
a stable sort with padding instead of data-dependent filtering, -1 labels
or zero rows for the empty slots — so a detection head needs no host
sync; the greedy loops (`bipartite_match`, the NMS of `vision.ops`) run
on the device, one masked update a step. Every op runs on its inputs'
device (the prior and anchor generators on their feature map's). Orders
are the reference's: `jnp.argsort` and `lax.top_k` are stable, and so
is every sort here (`torch.argsort(..., stable=True)`).

`box_coder`'s decode broadcasts as the reference's does: with axis=1 the
deltas [N, M, 4] meet the priors as [M, 1], so `generate_proposals`
decodes its [1, M] deltas into an [M, M] grid and takes the first
prior's row — the reference's arithmetic, kept.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _nms(*args, **kw):
    from ...vision.ops import nms  # vision imports nn: resolved at call
    return nms(*args, **kw)


def _dev(x):
    return x.device if torch.is_tensor(x) else None


def _iou_matrix(a, b):
    """[N, 4] x [M, 4] xyxy -> [N, M] IoU."""
    area_a = (a[:, 2] - a[:, 0]).clamp_min(0) * (a[:, 3] - a[:, 1]) \
        .clamp_min(0)
    area_b = (b[:, 2] - b[:, 0]).clamp_min(0) * (b[:, 3] - b[:, 1]) \
        .clamp_min(0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter) \
        .clamp_min(1e-10)


def _top_k(x, k):
    """(values, indices) of the k largest, ties to the lower index (as
    `lax.top_k`)."""
    idx = torch.argsort(-x, stable=True)[:k]
    return x[idx], idx


def _f32(values, dev):
    return torch.tensor(values, dtype=torch.float32, device=dev)


def _corners(cx, cy, aw, ah):
    return torch.stack([cx - 0.5 * aw, cy - 0.5 * ah,
                        cx + 0.5 * aw, cy + 0.5 * ah], dim=-1)


# ---- anchors and priors ----

def anchor_generator(input, anchor_sizes=(64., 128., 256., 512.),  # noqa: A002
                     aspect_ratios=(0.5, 1.0, 2.0),
                     variance=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5, name=None):
    """Anchors per feature-map cell: (anchors [H, W, A, 4] xyxy,
    variances [H, W, A, 4])."""
    h, w = input.shape[2], input.shape[3]
    dev = _dev(input)
    ws, hs = [], []
    for s in anchor_sizes:
        for r in aspect_ratios:
            ws.append(s * np.sqrt(r))
            hs.append(s / np.sqrt(r))
    aw, ah = _f32(ws, dev), _f32(hs, dev)
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offset) \
        * stride[0]
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offset) \
        * stride[1]
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")  # [H, W]
    boxes = _corners(cxg[:, :, None], cyg[:, :, None], aw[None, None, :],
                     ah[None, None, :])
    var = _f32(variance, dev).expand(boxes.shape)
    return boxes, var


def prior_box(input, image, min_sizes, max_sizes=None,  # noqa: A002
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD prior boxes in normalized coordinates: (boxes [H, W, P, 4],
    variances). Only the two inputs' shapes are read."""
    fh, fw = input.shape[2], input.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    dev = _dev(input)
    step_w = steps[0] or iw / fw
    step_h = steps[1] or ih / fh
    ars = list(aspect_ratios)
    if flip:
        ars = ars + [1.0 / a for a in aspect_ratios if a != 1.0]
    ws, hs = [], []
    for ms in min_sizes:
        for a in ars:
            ws.append(ms * np.sqrt(a))
            hs.append(ms / np.sqrt(a))
        if max_sizes:
            mx = max_sizes[list(min_sizes).index(ms)]
            ws.append(np.sqrt(ms * mx))
            hs.append(np.sqrt(ms * mx))
    aw = _f32(ws, dev) / iw
    ah = _f32(hs, dev) / ih
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + offset) \
        * step_w / iw
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + offset) \
        * step_h / ih
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")
    boxes = _corners(cxg[:, :, None], cyg[:, :, None], aw[None, None, :],
                     ah[None, None, :])
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    return boxes, _f32(variance, dev).expand(boxes.shape)


def density_prior_box(input, image, densities, fixed_sizes,  # noqa: A002
                      fixed_ratios, variance=(0.1, 0.1, 0.2, 0.2),
                      clip=False, steps=(0.0, 0.0), offset=0.5,
                      flatten_to_2d=False, name=None):
    """Densified priors: each fixed size tiled on a density x density
    sub-grid of every cell."""
    fh, fw = input.shape[2], input.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    dev = _dev(input)
    step_w = steps[0] or iw / fw
    step_h = steps[1] or ih / fh
    all_w, all_h, all_sx, all_sy = [], [], [], []
    for size, dens in zip(fixed_sizes, densities):
        for ratio in fixed_ratios:
            bw = size * np.sqrt(ratio)
            bh = size / np.sqrt(ratio)
            shift = 1.0 / dens
            for di in range(dens):
                for dj in range(dens):
                    all_w.append(bw)
                    all_h.append(bh)
                    all_sx.append((dj + 0.5) * shift - 0.5)
                    all_sy.append((di + 0.5) * shift - 0.5)
    aw = _f32(all_w, dev) / iw
    ah = _f32(all_h, dev) / ih
    sx = _f32(all_sx, dev) * step_w / iw
    sy = _f32(all_sy, dev) * step_h / ih
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + offset) \
        * step_w / iw
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + offset) \
        * step_h / ih
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")
    boxes = _corners(cxg[:, :, None] + sx[None, None, :],
                     cyg[:, :, None] + sy[None, None, :], aw, ah)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    var = _f32(variance, dev).expand(boxes.shape)
    if flatten_to_2d:
        boxes = boxes.reshape(-1, 4)
        var = var.reshape(-1, 4)
    return boxes, var


# ---- box transforms ----

def box_clip(input, im_info, name=None):  # noqa: A002
    """xyxy boxes clipped to the image; im_info rows [h, w, scale]."""
    info = im_info.reshape(-1)
    hmax = info[0] / info[2].clamp_min(1e-8) - 1
    wmax = info[1] / info[2].clamp_min(1e-8) - 1
    zero = torch.zeros((), dtype=input.dtype, device=input.device)
    return torch.stack([
        torch.minimum(torch.maximum(input[..., 0], zero), wmax),
        torch.minimum(torch.maximum(input[..., 1], zero), hmax),
        torch.minimum(torch.maximum(input[..., 2], zero), wmax),
        torch.minimum(torch.maximum(input[..., 3], zero), hmax)], dim=-1)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """Encode boxes against priors ([N, M, 4] offsets of N targets
    against M priors), or decode deltas [N, M, 4] (or [N, 4])."""
    pb, tb, pbv = prior_box, target_box, prior_box_var
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + 0.5 * pw
    pcy = pb[:, 1] + 0.5 * ph
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + 0.5 * tw
        tcy = tb[:, 1] + 0.5 * th
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log((tw[:, None] / pw[None, :]).clamp_min(1e-10))
        dh = torch.log((th[:, None] / ph[None, :]).clamp_min(1e-10))
        out = torch.stack([dx, dy, dw, dh], dim=-1)
        if pbv is not None:
            out = out / pbv[None, :, :]
        return out
    if tb.dim() == 2:
        tb = tb[:, None, :]
    d = tb if pbv is None else tb * (pbv[None] if pbv.dim() == 2 else pbv)
    if axis == 0:
        pw_, ph_, pcx_, pcy_ = pw[None], ph[None], pcx[None], pcy[None]
    else:
        pw_, ph_ = pw[:, None], ph[:, None]
        pcx_, pcy_ = pcx[:, None], pcy[:, None]
    ocx = d[..., 0] * pw_ + pcx_
    ocy = d[..., 1] * ph_ + pcy_
    ow = torch.exp(d[..., 2]) * pw_
    oh = torch.exp(d[..., 3]) * ph_
    return torch.stack([ocx - 0.5 * ow, ocy - 0.5 * oh,
                        ocx + 0.5 * ow - norm, ocy + 0.5 * oh - norm],
                       dim=-1)


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip_val=4.135, name=None):
    """Per-class deltas [N, C·4] decoded (pixel boxes), and each row's box
    of its best non-background class."""
    pb, pbv, sc = prior_box, prior_box_var, box_score
    n, c = sc.shape
    d = (target_box.reshape(n, c, 4) * pbv[:, None, :]).clamp(
        -box_clip_val, box_clip_val)
    pw = (pb[:, 2] - pb[:, 0] + 1)[:, None]
    ph = (pb[:, 3] - pb[:, 1] + 1)[:, None]
    pcx = pb[:, 0][:, None] + 0.5 * pw
    pcy = pb[:, 1][:, None] + 0.5 * ph
    ocx = d[..., 0] * pw + pcx
    ocy = d[..., 1] * ph + pcy
    ow = torch.exp(d[..., 2]) * pw
    oh = torch.exp(d[..., 3]) * ph
    dec = torch.stack([ocx - 0.5 * ow, ocy - 0.5 * oh,
                       ocx + 0.5 * ow - 1, ocy + 0.5 * oh - 1], dim=-1)
    best = sc[:, 1:].argmax(dim=1) + 1  # column 0 is the background
    assigned = torch.gather(dec, 1, best[:, None, None].expand(n, 1, 4))
    return dec.reshape(n, c * 4), assigned[:, 0]


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    """Greedy bipartite matching: min(N, M) times, the largest remaining
    entry (> 0) matches its row and column, which then leave. Returns
    (row of each column [1, M], -1 unmatched; its distance [1, M]). The
    loop runs on the device."""
    d = dist_matrix
    n, m = d.shape
    dev = d.device
    work = d.clone()
    row_of_col = torch.full((m,), -1, dtype=torch.int32, device=dev)
    dist_of_col = torch.zeros(m, dtype=d.dtype, device=dev)
    neg = torch.tensor(-1.0, dtype=d.dtype, device=dev)
    for _ in range(min(n, m)):
        flat = work.reshape(-1).argmax()
        i, j = flat // m, flat % m
        best = work[i, j]
        ok = best > 0
        row_of_col = torch.where(ok, row_of_col.index_put(
            (j[None],), i.to(torch.int32)[None]), row_of_col)
        dist_of_col = torch.where(ok, dist_of_col.index_put(
            (j[None],), best[None]), dist_of_col)
        cleared = work.index_put((i[None],), neg)
        cleared = cleared.index_put(
            (torch.arange(n, device=dev), j.expand(n)), neg)
        work = torch.where(ok, cleared, work)
    if match_type == "per_prediction" and dist_threshold is not None:
        col_best = d.argmax(dim=0).to(torch.int32)
        col_val = d.amax(dim=0)
        extra = (row_of_col < 0) & (col_val >= dist_threshold)
        row_of_col = torch.where(extra, col_best, row_of_col)
        dist_of_col = torch.where(extra, col_val, dist_of_col)
    return row_of_col[None], dist_of_col[None]


def target_assign(input, matched_indices, negative_indices=None,  # noqa: A002
                  mismatch_value=0, name=None):
    """Per-prior targets gathered by match index ([N, M, K]; unmatched
    rows mismatch_value) and their weights [N, M, 1]."""
    mi = matched_indices.long()
    safe = mi.clamp_min(0)
    out = torch.gather(input, 1, safe[:, :, None].expand(
        -1, -1, input.shape[-1]))
    matched = (mi >= 0)[:, :, None]
    out = torch.where(matched, out, torch.as_tensor(
        mismatch_value, dtype=input.dtype, device=input.device))
    return out, matched.float()[..., 0:1]


# ---- NMS ----

def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=400,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None,
                   return_index=False):
    """Per-class NMS, then the keep_top_k best rows overall: a fixed
    [keep_top_k, 6] output of [class, score, x1, y1, x2, y2], empty rows
    with class -1 (one image: a batch gives its first)."""
    bv, sv = bboxes, scores
    if bv.dim() == 3:
        bv, sv = bv[0], sv[0]
    c, m = sv.shape[0], sv.shape[1]
    outs = []
    for cls in range(c):
        if cls == background_label:
            continue
        s = sv[cls]
        boxes_c = bv if bv.dim() == 2 else bv[:, cls]
        keep_n = min(nms_top_k, m) if nms_top_k > 0 else m
        kept = _nms(boxes_c, s, iou_threshold=nms_threshold, top_k=keep_n)
        valid = kept >= 0
        safe = kept.clamp_min(0).long()
        ks = torch.where(valid, s[safe], torch.full_like(s[safe], -1.0))
        pass_thr = valid & (ks >= score_threshold)
        cls_col = torch.where(pass_thr, float(cls), -1.0).to(ks.dtype)
        outs.append(torch.cat([cls_col[:, None], ks[:, None],
                               boxes_c[safe]], dim=1))
    allr = torch.cat(outs, dim=0)
    k = min(keep_top_k, allr.shape[0]) if keep_top_k > 0 else allr.shape[0]
    key = torch.where(allr[:, 0] >= 0, allr[:, 1],
                      torch.full_like(allr[:, 1], -math.inf))
    order = torch.argsort(-key, stable=True)
    top = allr[order[:k]]
    if return_index:
        return top, order[:k]
    return top


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=100, score_threshold=0.01, nms_eta=1.0,
                     return_index=False):
    """SSD head: deltas decoded against the priors, then multiclass
    NMS."""
    dv = box_coder(prior_box, prior_box_var, loc,
                   code_type="decode_center_size")
    if dv.dim() == 3 and dv.shape[1] != 1:
        dv = dv[:, 0]
    sv = scores[0].T if scores.dim() == 3 else scores
    return multiclass_nms(dv, sv, score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          background_label=background_label,
                          return_index=return_index)


# ---- RoI ops ----

def _grid(r, ph, pw, floor, dev):
    x1, y1, x2, y2 = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    bw = (x2 - x1).clamp_min(floor)
    bh = (y2 - y1).clamp_min(floor)
    ys = y1[:, None] + (torch.arange(ph, device=dev) + 0.5)[None, :] / ph \
        * bh[:, None]
    xs = x1[:, None] + (torch.arange(pw, device=dev) + 0.5)[None, :] / pw \
        * bw[:, None]
    return ys, xs, bh, bw


def _nearest(v, hi):
    return torch.round(v).long().clamp(0, hi - 1)


def roi_pool(input, boxes, boxes_num=None, output_size=1,  # noqa: A002
             spatial_scale=1.0, name=None):
    """RoI pooling over the first image: each bin reads the pixel nearest
    its centre -> [R, C, oh, ow]."""
    oh, ow = output_size if isinstance(output_size, (tuple, list)) \
        else (output_size, output_size)
    h, w = input.shape[2], input.shape[3]
    ys, xs, _, _ = _grid(boxes * spatial_scale, oh, ow, 1.0, input.device)
    yi, xi = _nearest(ys, h), _nearest(xs, w)
    g = input[0][:, yi[:, :, None], xi[:, None, :]]  # [C, R, oh, ow]
    return g.permute(1, 0, 2, 3)


def psroi_pool(input, boxes, boxes_num=None, output_channels=None,  # noqa: A002
               spatial_scale=1.0, pooled_height=1, pooled_width=1,
               name=None):
    """Position-sensitive RoI pooling: channel group (i, j) feeds output
    bin (i, j)."""
    ph, pw = pooled_height, pooled_width
    c_out = output_channels or input.shape[1] // (ph * pw)
    h, w = input.shape[2], input.shape[3]
    dev = input.device
    ys, xs, _, _ = _grid(boxes * spatial_scale, ph, pw, 0.1, dev)
    yi, xi = _nearest(ys, h), _nearest(xs, w)
    feat = input[0].reshape(c_out, ph, pw, h, w)
    ii = torch.arange(ph, device=dev)[None, :, None]
    jj = torch.arange(pw, device=dev)[None, None, :]
    g = feat[:, ii, jj, yi[:, :, None], xi[:, None, :]]
    return g.permute(1, 0, 2, 3)


def prroi_pool(input, boxes, output_size=1, spatial_scale=1.0,  # noqa: A002
               name=None):
    """Precise RoI pooling, as the reference: RoI Align with two samples a
    bin's side requested (one taken)."""
    from ...vision.ops import roi_align
    n = boxes.shape[0]
    return roi_align(input, boxes, boxes_num=torch.tensor(
        [n], dtype=torch.int32, device=input.device),
        output_size=output_size, spatial_scale=spatial_scale,
        sampling_ratio=2)


def deformable_roi_pooling(input, rois, trans, no_trans=False,  # noqa: A002
                           spatial_scale=1.0, group_size=1, pooled_height=1,
                           pooled_width=1, part_size=None, sample_per_part=1,
                           trans_std=0.1, position_sensitive=False,
                           name=None):
    """Deformable RoI pooling: the bins' centres shifted by the learned
    offsets (trans [R, 2, ph, pw], averaged per row / column) before the
    nearest-pixel read."""
    ph, pw = pooled_height, pooled_width
    h, w = input.shape[2], input.shape[3]
    ys, xs, bh, bw = _grid(rois * spatial_scale, ph, pw, 0.1, input.device)
    if not no_trans and trans is not None:
        ys = ys + trans[:, 0].reshape(-1, ph, pw).mean(dim=2) * trans_std \
            * bh[:, None]
        xs = xs + trans[:, 1].reshape(-1, ph, pw).mean(dim=1) * trans_std \
            * bw[:, None]
    yi, xi = _nearest(ys, h), _nearest(xs, w)
    return input[0][:, yi[:, :, None], xi[:, None, :]].permute(1, 0, 2, 3)


def roi_perspective_transform(input, rois, transformed_height,  # noqa: A002
                              transformed_width, spatial_scale=1.0):
    """Quad RoIs (8 coordinates) warped to a fixed grid by bilinear
    interpolation of the corners, nearest-pixel reads: (out [R, C, th,
    tw], mask of ones [R, 1, th, tw])."""
    quads = rois.reshape(-1, 4, 2) * spatial_scale
    th, tw = transformed_height, transformed_width
    dev = input.device
    u = (torch.arange(tw, dtype=torch.float32, device=dev) + 0.5) / tw
    v = (torch.arange(th, dtype=torch.float32, device=dev) + 0.5) / th
    ug, vg = torch.meshgrid(u, v, indexing="xy")  # [th, tw]
    p = (quads[:, None, None, 0] * ((1 - ug) * (1 - vg))[None, :, :, None]
         + quads[:, None, None, 1] * (ug * (1 - vg))[None, :, :, None]
         + quads[:, None, None, 2] * (ug * vg)[None, :, :, None]
         + quads[:, None, None, 3] * ((1 - ug) * vg)[None, :, :, None])
    h, w = input.shape[2], input.shape[3]
    xi, yi = _nearest(p[..., 0], w), _nearest(p[..., 1], h)
    out = input[0][:, yi, xi].permute(1, 0, 2, 3)
    mask = torch.ones(quads.shape[0], 1, th, tw, dtype=torch.int32,
                      device=dev)
    return out, mask


# ---- the proposal pipeline ----

def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=False, name=None):
    """RPN proposals of the first image: deltas decoded, clipped, the
    pre_nms_top_n best scores kept (boxes under min_size scored -1), NMS,
    then post_nms_top_n rows padded with zeros: (rois [K, 4], scores
    [K, 1][, the count of valid rows [1]])."""
    n, a, h, w = scores.shape
    av = anchors.reshape(-1, 4)
    vv = variances.reshape(-1, 4)
    s = scores[0].permute(1, 2, 0).reshape(-1)
    d = bbox_deltas[0].reshape(a, 4, h, w).permute(2, 3, 0, 1).reshape(-1, 4)
    boxes = box_coder(av, vv, d[None], code_type="decode_center_size",
                      axis=1).reshape(-1, 4)
    boxes = box_clip(boxes, im_info)
    k = min(pre_nms_top_n, s.shape[0])
    top_s, top_i = _top_k(s, k)
    top_b = boxes[top_i]
    wh_ok = ((top_b[:, 2] - top_b[:, 0] >= min_size)
             & (top_b[:, 3] - top_b[:, 1] >= min_size))
    top_s = torch.where(wh_ok, top_s, torch.full_like(top_s, -1.0))
    kept = _nms(top_b, top_s, iou_threshold=nms_thresh, top_k=post_nms_top_n)
    valid = kept >= 0
    safe = kept.clamp_min(0).long()
    out_b = torch.where(valid[:, None], top_b[safe],
                        torch.zeros((), dtype=top_b.dtype,
                                    device=top_b.device))
    out_s = torch.where(valid, top_s[safe],
                        torch.zeros((), dtype=top_s.dtype,
                                    device=top_s.device))
    if return_rois_num:
        return out_b, out_s[:, None], valid.to(torch.int32).sum()[None]
    return out_b, out_s[:, None]


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=False):
    """Anchors labelled foreground / background by IoU with the ground
    truth (each gt's best anchor foreground too); the sample is the top
    of each class by IoU, not random. Returns (loc index, score index,
    target deltas, target labels, the labelled-anchor mask)."""
    ab = anchor_box.reshape(-1, 4)
    gb = gt_boxes.reshape(-1, 4)
    dev = ab.device
    iou = _iou_matrix(ab, gb)  # [A, G]
    best_gt = iou.argmax(dim=1)
    best_iou = iou.amax(dim=1)
    labels = torch.where(
        best_iou >= rpn_positive_overlap, 1,
        torch.where(best_iou < rpn_negative_overlap, 0, -1))
    labels = labels.index_put((iou.argmax(dim=0),),
                              torch.ones((), dtype=labels.dtype,
                                         device=dev))
    fg_target = int(rpn_batch_size_per_im * rpn_fg_fraction)
    minus1 = torch.full_like(best_iou, -1.0)
    fg_idx = _top_k(torch.where(labels == 1, best_iou, minus1),
                    min(fg_target, ab.shape[0]))[1]
    bg_idx = _top_k(torch.where(labels == 0, 1.0 - best_iou, minus1),
                    min(rpn_batch_size_per_im - fg_target,
                        ab.shape[0]))[1]
    score_idx = torch.cat([fg_idx, bg_idx])
    tgt = box_coder(ab[fg_idx], None, gb[best_gt[fg_idx]],
                    code_type="encode_center_size")
    tgt_box = torch.diagonal(tgt, 0, 0, 1).T if tgt.dim() == 3 else tgt
    tgt_lbl = torch.cat([torch.ones_like(fg_idx),
                         torch.zeros_like(bg_idx)])[:, None]
    return (fg_idx, score_idx, tgt_box, tgt_lbl,
            (labels >= 0).to(torch.int32))


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd=None, im_info=None,
                            num_classes=1, positive_overlap=0.5,
                            negative_overlap=0.4):
    """RetinaNet's anchor labels: `rpn_target_assign` at its overlaps,
    plus each foreground anchor's class and the foreground count."""
    loc_idx, score_idx, tgt_box, tgt_lbl, mask = rpn_target_assign(
        bbox_pred, cls_logits, anchor_box, anchor_var, gt_boxes, is_crowd,
        im_info, rpn_positive_overlap=positive_overlap,
        rpn_negative_overlap=negative_overlap)
    ab = anchor_box.reshape(-1, 4)
    gb = gt_boxes.reshape(-1, 4)
    gl = gt_labels.reshape(-1)
    iou = _iou_matrix(ab, gb)
    cls = gl[iou.argmax(dim=1)][loc_idx]
    fg_num = (iou.amax(dim=1) >= positive_overlap).to(torch.int32).sum()
    return (loc_idx, score_idx, tgt_box, cls[:, None], mask, fg_num[None])


def retinanet_detection_output(bboxes, scores, im_info, score_threshold=0.05,
                               nms_top_k=1000, keep_top_k=100,
                               nms_threshold=0.3, nms_eta=1.0):
    """The levels' boxes and scores concatenated, then multiclass NMS
    over every class."""
    bv = bboxes if isinstance(bboxes, (list, tuple)) else [bboxes]
    sv = scores if isinstance(scores, (list, tuple)) else [scores]
    allb = torch.cat([b.reshape(-1, 4) for b in bv], dim=0)
    alls = torch.cat([s.reshape(-1, s.shape[-1]) for s in sv], dim=0)
    return multiclass_nms(allb, alls.T, score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold, background_label=-1)


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256, fg_fraction=0.25,
                             fg_thresh=0.5, bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=81, use_random=False,
                             is_cls_agnostic=False, is_cascade_rcnn=False):
    """Foreground / background RoIs for the RCNN head (the top of each by
    IoU, not random) with their labels and per-class regression targets:
    (rois, labels [K, 1], targets [K, 4·classes], inside and outside
    weights)."""
    rois = rpn_rois.reshape(-1, 4)
    gb = gt_boxes.reshape(-1, 4)
    gc = gt_classes.reshape(-1)
    iou = _iou_matrix(rois, gb)
    best_gt = iou.argmax(dim=1)
    best_iou = iou.amax(dim=1)
    fg_target = int(batch_size_per_im * fg_fraction)
    minus1 = torch.full_like(best_iou, -1.0)
    fg_idx = _top_k(torch.where(best_iou >= fg_thresh, best_iou, minus1),
                    min(fg_target, rois.shape[0]))[1]
    bg_mask = (best_iou < bg_thresh_hi) & (best_iou >= bg_thresh_lo)
    bg_idx = _top_k(torch.where(bg_mask, 1.0 - best_iou, minus1),
                    min(batch_size_per_im - fg_target, rois.shape[0]))[1]
    keep = torch.cat([fg_idx, bg_idx])
    out_rois = rois[keep]
    labels = torch.cat([gc[best_gt[fg_idx]], torch.zeros_like(
        bg_idx, dtype=gc.dtype)]).to(torch.int32)
    deltas = box_coder(out_rois, None, gb[best_gt[keep]],
                       code_type="encode_center_size")
    if deltas.dim() == 3:
        deltas = torch.diagonal(deltas, 0, 0, 1).T
    deltas = deltas / torch.tensor(bbox_reg_weights, dtype=deltas.dtype,
                                   device=deltas.device)
    n = keep.shape[0]
    tgt = torch.zeros(n, 4 * class_nums, dtype=deltas.dtype,
                      device=deltas.device)
    col = labels.long() * 4
    rowi = torch.arange(n, device=deltas.device)
    for k in range(4):
        tgt = tgt.index_put((rowi, col + k), deltas[:, k])
    w_in = (labels > 0).float()[:, None] * torch.ones(
        n, 4 * class_nums, device=deltas.device)
    return out_rois, labels[:, None], tgt, w_in, w_in


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution):
    """Mask targets: the first gt mask (binary [G, H, W]) read at each
    RoI's res x res grid (nearest pixel); -1 for background RoIs."""
    rv = rois.reshape(-1, 4)
    lab = labels_int32.reshape(-1)
    seg = gt_segms
    n = rv.shape[0]
    res = resolution
    h, w = seg.shape[-2], seg.shape[-1]
    dev = rv.device
    x1, y1, x2, y2 = rv[:, 0], rv[:, 1], rv[:, 2], rv[:, 3]
    grid = (torch.arange(res, device=dev) + 0.5)[None, :] / res
    ys = y1[:, None] + grid * (y2 - y1).clamp_min(1)[:, None]
    xs = x1[:, None] + grid * (x2 - x1).clamp_min(1)[:, None]
    yi, xi = _nearest(ys, h), _nearest(xs, w)
    m = seg[0] if seg.dim() == 3 else seg
    tgt = m[yi[:, :, None], xi[:, None, :]].to(torch.int32)
    tgt = torch.where((lab > 0)[:, None, None], tgt,
                      torch.full_like(tgt, -1))
    return rv, lab[:, None], tgt.reshape(n, -1)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    """RoIs routed to FPN levels by scale. Static shapes: every level gets
    the whole list with the rows of other levels zeroed, and restore_ind
    gives the original order."""
    rv = fpn_rois.reshape(-1, 4)
    scale = torch.sqrt((rv[:, 2] - rv[:, 0]).clamp_min(0)
                       * (rv[:, 3] - rv[:, 1]).clamp_min(0))
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = lvl.clamp(min_level, max_level).to(torch.int32)
    outs, nums = [], []
    for level in range(min_level, max_level + 1):
        m = (lvl == level)[:, None]
        outs.append(torch.where(m, rv, torch.zeros((), dtype=rv.dtype,
                                                   device=rv.device)))
        nums.append(m.to(torch.int32).sum())
    restore = torch.argsort(torch.argsort(lvl, stable=True), stable=True)
    if rois_num is not None:
        return outs, restore[:, None], [n[None] for n in nums]
    return outs, restore[:, None]


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, rois_num_per_level=None, name=None):
    """The levels' RoIs merged; the post_nms_top_n best by score kept."""
    rv = torch.cat([r.reshape(-1, 4) for r in multi_rois], dim=0)
    sv = torch.cat([s.reshape(-1) for s in multi_scores], dim=0)
    k = min(post_nms_top_n, sv.shape[0])
    _, top_i = _top_k(sv, k)
    if rois_num_per_level is not None:
        return rv[top_i], torch.tensor([k], dtype=torch.int32,
                                       device=rv.device)
    return rv[top_i]


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None):
    """SSD's multi-scale head: per level a location and a confidence conv
    (made at a level's first call and kept in `multi_box_head._cache`)
    and the priors: (locations [N, P, 4], confidences [N, P, classes],
    boxes [P, 4], variances [P, 4])."""
    from ...device import device_guard
    from .. import Conv2D
    n_levels = len(inputs)
    if min_sizes is None:
        assert min_ratio is not None and max_ratio is not None
        step = int((max_ratio - min_ratio) / (n_levels - 2))
        min_sizes, max_sizes = [], []
        for r in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * r / 100.0)
            max_sizes.append(base_size * (r + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes
        max_sizes = [base_size * 0.2] + max_sizes
    locs, confs, boxes, vars_ = [], [], [], []
    for i, x in enumerate(inputs):
        mi = [min_sizes[i]] if np.isscalar(min_sizes[i]) else min_sizes[i]
        mx = [max_sizes[i]] if np.isscalar(max_sizes[i]) else max_sizes[i]
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i], (list, tuple)) \
            else [aspect_ratios[i]]
        b, v = prior_box(x, image, mi, mx, ar, variance, flip, clip,
                         steps[i] if steps else (0.0, 0.0), offset)
        nb = int(math.prod(b.shape[:-1]) // (x.shape[2] * x.shape[3]))
        cin = x.shape[1]
        key = ("loc", i, cin, nb)
        if key not in multi_box_head._cache:
            with device_guard(x.device):
                multi_box_head._cache[key] = Conv2D(
                    cin, nb * 4, kernel_size, padding=pad, stride=stride)
                multi_box_head._cache[("conf", i, cin, nb)] = Conv2D(
                    cin, nb * num_classes, kernel_size, padding=pad,
                    stride=stride)
        loc = multi_box_head._cache[key](x)
        conf = multi_box_head._cache[("conf", i, cin, nb)](x)
        locs.append(loc.permute(0, 2, 3, 1).reshape(x.shape[0], -1, 4))
        confs.append(conf.permute(0, 2, 3, 1).reshape(x.shape[0], -1,
                                                      num_classes))
        boxes.append(b.reshape(-1, 4))
        vars_.append(v.reshape(-1, 4))
    return (torch.cat(locs, dim=1), torch.cat(confs, dim=1),
            torch.cat(boxes, dim=0), torch.cat(vars_, dim=0))


multi_box_head._cache = {}


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, name=None,
             scale_x_y=1.0):
    """The YOLO head decoded to pixel boxes [N, A·H·W, 4] (clipped to
    the image) and per-class scores [N, A·H·W, classes]; rows under
    conf_thresh are zeros."""
    from ...vision.ops import yolo_box_decode
    bv, cv = yolo_box_decode(x, anchors, downsample_ratio=downsample_ratio,
                             class_num=class_num, conf_thresh=conf_thresh)
    n, _, h, w = x.shape
    a = len(anchors) // 2
    cls_prob = torch.sigmoid(x.reshape(n, a, 5 + class_num, h, w)[:, :, 5:])
    scores = cv[..., None] * cls_prob.permute(0, 1, 3, 4, 2).reshape(
        n, -1, class_num)
    img = img_size.float()  # [N, 2] (h, w)
    scale = torch.stack([img[:, 1], img[:, 0], img[:, 1], img[:, 0]],
                        dim=1)[:, None, :]
    abs_boxes = bv * scale
    if clip_bbox:
        abs_boxes = torch.minimum(abs_boxes.clamp_min(0), scale - 1)
    keep = cv >= conf_thresh
    zero = torch.zeros((), dtype=abs_boxes.dtype, device=abs_boxes.device)
    return (torch.where(keep[..., None], abs_boxes, zero),
            torch.where(keep[..., None], scores, zero))


def _bce_logits(z, t):
    return z.clamp_min(0) - z * t + torch.log1p(torch.exp(-z.abs()))


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh=0.7, downsample_ratio=32, gt_score=None,
                use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3's training loss, [1]: squared error on the assigned cells'
    coordinates, BCE on the objectness of every cell and on the assigned
    cells' classes (label-smoothed). gt_box [N, G, 4] normalized cx, cy,
    w, h; zero-size rows are padding."""
    gb = gt_box
    gl = gt_label.long()
    n, _, h, w = x.shape
    dev = x.device
    a = len(anchor_mask)
    pred = x.reshape(n, a, 5 + class_num, h, w)
    px = torch.sigmoid(pred[:, :, 0])
    py = torch.sigmoid(pred[:, :, 1])
    pw, ph, pobj = pred[:, :, 2], pred[:, :, 3], pred[:, :, 4]
    pcls = pred[:, :, 5:]
    masked = [(anchors[2 * i], anchors[2 * i + 1]) for i in anchor_mask]
    in_w, in_h = w * downsample_ratio, h * downsample_ratio
    g = gb.shape[1]
    gi = (gb[..., 0] * w).to(torch.int32).clamp(0, w - 1).long()
    gj = (gb[..., 1] * h).to(torch.int32).clamp(0, h - 1).long()
    aw = _f32([m[0] for m in masked], dev) / in_w
    ah = _f32([m[1] for m in masked], dev) / in_h
    inter = (torch.minimum(gb[..., 2][..., None], aw)
             * torch.minimum(gb[..., 3][..., None], ah))
    union = (gb[..., 2] * gb[..., 3])[..., None] + aw * ah - inter
    best_a = (inter / union.clamp_min(1e-10)).argmax(dim=-1)  # [N, G]
    valid = (gb[..., 2] > 0) & (gb[..., 3] > 0)
    tx = gb[..., 0] * w - gi
    ty = gb[..., 1] * h - gj
    tw = torch.log((gb[..., 2] * in_w).clamp_min(1e-9)
                   / (aw[best_a] * in_w).clamp_min(1e-9))
    th = torch.log((gb[..., 3] * in_h).clamp_min(1e-9)
                   / (ah[best_a] * in_h).clamp_min(1e-9))
    bidx = torch.arange(n, device=dev)[:, None].expand(n, g)
    sel = (bidx, best_a, gj, gi)
    vf = valid.float()
    box_loss = (vf * ((px[sel] - tx) ** 2 + (py[sel] - ty) ** 2
                      + (pw[sel] - tw) ** 2 + (ph[sel] - th) ** 2)).sum()
    flat = ((bidx * a + best_a) * h + gj) * w + gi
    tobj = torch.zeros(n * a * h * w, device=dev).scatter_reduce(
        0, flat.reshape(-1), vf.reshape(-1), "amax").reshape(n, a, h, w)
    obj_loss = _bce_logits(pobj, tobj).sum()
    tcls = torch.nn.functional.one_hot(gl, class_num).float()
    if use_label_smooth:
        delta = 1.0 / max(class_num, 1)
        tcls = tcls * (1 - delta) + delta * 0.5
    pcls_s = pcls.permute(0, 1, 3, 4, 2)[sel]  # [N, G, C]
    cls_loss = (vf[..., None] * _bce_logits(pcls_s, tcls)).sum()
    return (box_loss + obj_loss + cls_loss)[None]


def iou_similarity(x, y, box_normalized=True, name=None):
    """Pairwise IoU [N, M]."""
    return _iou_matrix(x, y)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None):
    """SSD's multibox loss [B, P, 1]: priors matched to the ground truth
    by IoU; smooth-L1 on the encoded offsets of the positives; softmax
    cross entropy on the positives and the hardest negatives (up to
    neg_pos_ratio a positive). gt_box [B, G, 4], gt_label [B, G] (zero-
    area rows are padding); location [B, P, 4]; confidence [B, P, C];
    prior_box [P, 4]."""
    gl_all = gt_label.reshape(gt_box.shape[0], -1)
    pb = prior_box
    b, p, c = confidence.shape
    dev = confidence.device
    var = prior_box_var if prior_box_var is not None else \
        torch.tensor([0.1, 0.1, 0.2, 0.2], device=dev)
    var = var if var.dim() == 1 else var[0]
    pw = pb[:, 2] - pb[:, 0]
    ph = pb[:, 3] - pb[:, 1]
    pcx = pb[:, 0] + 0.5 * pw
    pcy = pb[:, 1] + 0.5 * ph
    out = []
    for i in range(b):
        gb_i, gl_i = gt_box[i], gl_all[i]
        valid = (gb_i[:, 2] - gb_i[:, 0]) * (gb_i[:, 3] - gb_i[:, 1]) > 0
        iou = torch.where(valid[None, :], _iou_matrix(pb, gb_i),
                          torch.zeros((), device=dev))
        best_gt = iou.argmax(dim=1)
        best_iou = iou.amax(dim=1)
        pos = best_iou >= overlap_threshold
        matched = torch.where(pos, gl_i[best_gt].long(),
                              torch.full_like(best_gt, background_label))
        mg = gb_i[best_gt]
        gw = (mg[:, 2] - mg[:, 0]).clamp_min(1e-8)
        gh = (mg[:, 3] - mg[:, 1]).clamp_min(1e-8)
        gcx = mg[:, 0] + 0.5 * gw
        gcy = mg[:, 1] + 0.5 * gh
        enc = torch.stack([(gcx - pcx) / pw / var[0],
                           (gcy - pcy) / ph / var[1],
                           torch.log(gw / pw) / var[2],
                           torch.log(gh / ph) / var[3]], dim=-1)
        l1 = (location[i] - enc).abs()
        loc_l = torch.where(l1 < 1.0, 0.5 * l1 * l1, l1 - 0.5).sum(-1)
        loc_l = torch.where(pos, loc_l, torch.zeros((), device=dev))
        logp = torch.log_softmax(confidence[i], dim=-1)
        ce = -torch.gather(logp, 1, matched[:, None])[:, 0]
        n_pos = pos.sum().clamp_min(1)
        n_neg = torch.minimum((neg_pos_ratio * n_pos).to(torch.int32),
                              (p - n_pos).to(torch.int32))
        neg_score = torch.where(pos | (best_iou >= neg_overlap),
                                torch.full_like(ce, -math.inf), ce)
        order = torch.argsort(-neg_score, stable=True)
        neg_rank = torch.zeros(p, dtype=torch.int32, device=dev).index_put(
            (order,), torch.arange(p, dtype=torch.int32, device=dev))
        neg = (~pos) & (neg_rank < n_neg) & torch.isfinite(neg_score)
        conf_l = torch.where(pos | neg, ce, torch.zeros((), device=dev))
        total = conf_loss_weight * conf_l + loc_loss_weight * loc_l
        if normalize:
            total = total / n_pos
        out.append(total)
    return torch.stack(out)[..., None]


__all__ = [
    "anchor_generator", "prior_box", "density_prior_box", "box_clip",
    "box_coder", "box_decoder_and_assign", "bipartite_match",
    "target_assign", "multiclass_nms", "detection_output", "roi_pool",
    "psroi_pool", "prroi_pool", "deformable_roi_pooling",
    "roi_perspective_transform", "generate_proposals", "rpn_target_assign",
    "retinanet_target_assign", "retinanet_detection_output",
    "generate_proposal_labels", "generate_mask_labels",
    "distribute_fpn_proposals", "collect_fpn_proposals", "multi_box_head",
    "yolo_box", "yolov3_loss", "iou_similarity", "ssd_loss"]
