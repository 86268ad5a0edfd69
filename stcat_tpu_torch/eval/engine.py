"""Two-stream temporal supersampling: decode postprocessed rows, merge the
even/odd streams and linearly interpolate boxes back to the full frame rate.
Host-side python on small numpy arrays."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def linear_interp_boxes(bbox_dict: Dict[int, List[List[float]]]) -> Dict:
    """Fill frame-id gaps by linear interpolation."""
    fids = sorted(bbox_dict)
    if len(fids) < 2:
        return bbox_dict
    for a, b in zip(fids[:-1], fids[1:]):
        gap = b - a
        if gap > 1:
            left = np.asarray(bbox_dict[a][0], np.float64)
            right = np.asarray(bbox_dict[b][0], np.float64)
            delta = (right - left) / gap
            for s in range(1, gap):
                bbox_dict[a + s] = [(left + s * delta).tolist()]
    return {fid: bbox_dict[fid] for fid in sorted(bbox_dict)}


def _decode_rows(boxes, s_idx, e_idx, frame_valid, meta, row0):
    """Rows [row0, row0+len(meta)) of a postprocessed batch -> pred dicts,
    skipping filler rows (meta['pad'])."""
    bbox_pred, temp_pred = {}, {}
    for j, m in enumerate(meta):
        if m.get("pad"):
            continue
        i = row0 + j
        fids = m["frame_ids"]
        n = int(np.asarray(frame_valid[i]).sum())
        if n != len(fids):
            raise ValueError(f"row {i}: {n} valid frames for {len(fids)} frame ids")
        bbox_pred[m["item_id"]] = {fids[k]: [boxes[i, k].tolist()] for k in range(n)}
        temp_pred[m["item_id"]] = {
            "sted": [fids[int(s_idx[i])], fids[int(e_idx[i])] + 1],
            "qtype": m.get("qtype", "none"),
        }
    return bbox_pred, temp_pred


def merge_two_streams(boxes, s_idx, e_idx, frame_valid, m1, m2):
    """Union the two streams' per-frame boxes, interpolate the gaps, and take
    the min/max envelope of their spans. Rows [0, len(m1)) are stream 0,
    the next len(m2) rows stream 1."""
    bbox1, temp1 = _decode_rows(boxes, s_idx, e_idx, frame_valid, m1, 0)
    bbox2, temp2 = _decode_rows(boxes, s_idx, e_idx, frame_valid, m2, len(m1))
    bbox_pred, temp_pred = {}, {}
    for vid in bbox1:
        bbox1[vid].update(bbox2[vid])
        bbox_pred[vid] = linear_interp_boxes(bbox1[vid])
        temp_pred[vid] = {
            "sted": [min(temp1[vid]["sted"][0], temp2[vid]["sted"][0]),
                     max(temp1[vid]["sted"][1], temp2[vid]["sted"][1])],
            "qtype": temp1[vid].get("qtype", "none"),
        }
    return bbox_pred, temp_pred
