"""Mean squared distance to the k nearest neighbours, for scale
initialisation. Port of `gsattack/ops/knn.py`: exact squared distances by
rows of `chunk` points against all N (the cross term one matmul per
chunk), then the k + 1 smallest with the point itself dropped. O(N^2)
work, run once when a scene is made from a point cloud.
"""

from __future__ import annotations

import torch


def mean_knn_dist2(points: torch.Tensor, k: int = 3, chunk: int = 512) -> torch.Tensor:
    """(N, 3) -> (N,) mean squared distance to the k nearest neighbours.
    The (chunk, N) distance block is 200 MB at N = 100k; the smallest
    distance of each row, its own, is dropped."""
    points = points.to(torch.float32)
    n = points.shape[0]
    sq = torch.sum(points * points, dim=-1)
    kk = min(k + 1, n)
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    for lo in range(0, n, chunk):
        c_pts, c_sq = points[lo:lo + chunk], sq[lo:lo + chunk]
        d2 = c_sq[:, None] - 2.0 * (c_pts @ points.T) + sq[None, :]
        d2 = torch.clamp(d2, min=0.0)
        knn = torch.topk(d2, kk, dim=1, largest=False).values[:, 1:]
        out[lo:lo + chunk] = knn.mean(dim=-1) if knn.shape[1] else 0.0
    return out
