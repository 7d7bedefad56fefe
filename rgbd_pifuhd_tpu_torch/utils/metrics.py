"""Occupancy evaluation metrics (port of ``utils/metrics.py``):

- ``compute_acc``: IoU, precision and recall of thresholded occupancy;
- ``chamfer_l2``: the symmetric squared Chamfer distance of two point sets
  (O(N M): use subsampled sets);
- ``calc_error``: the dataset-level mean of (loss, IoU, precision, recall)
  over the first ``num_tests`` items.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_acc(pred: torch.Tensor, gt: torch.Tensor, thresh: float = 0.5):
    """-> (IoU, precision, recall) over ``pred > thresh`` against
    ``gt > thresh``, elementwise over any matching shapes."""
    p = pred > thresh
    g = gt > thresh
    inter = (p & g).sum()
    union = (p | g).sum()
    vol_p, vol_g = p.sum(), g.sum()
    iou = inter / torch.clamp(union, min=1)
    prec = inter / torch.clamp(vol_p, min=1)
    rec = inter / torch.clamp(vol_g, min=1)
    return iou, prec, rec


def chamfer_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric Chamfer distance between ``a [N, 3]`` and ``b [M, 3]``:
    the mean squared distance to the nearest point, both ways."""
    d2 = torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1)
    return torch.mean(d2.min(dim=1).values) + torch.mean(d2.min(dim=0).values)


def calc_error(model_apply, params, dataset, collate, num_tests: int,
               thresh: float = 0.5):
    """Mean (loss, IoU, precision, recall) over the first ``num_tests``
    items, one at a time; ``model_apply(params, batch) -> (loss, preds,
    labels)``."""
    rows = []
    for i in range(min(num_tests, len(dataset))):
        loss, preds, labels = model_apply(params, collate([dataset[i]]))
        iou, prec, rec = compute_acc(torch.as_tensor(preds),
                                     torch.as_tensor(labels), thresh)
        rows.append([float(loss), float(iou), float(prec), float(rec)])
    return tuple(np.mean(rows, axis=0))
