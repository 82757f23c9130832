"""Convex-hull membership for grouped-object selection, the port of
`gsattack/ops/hull.py`: an IQR outlier filter on the selected points, then
membership of every point in the Delaunay triangulation of the rest
(scipy, imported inside the function). Host-side numpy float64, one-shot
scene set-up."""

from __future__ import annotations

import numpy as np


def points_inside_convex_hull(
    points: np.ndarray,
    mask: np.ndarray,
    remove_outliers: bool = True,
    outlier_factor: float = 1.0,
) -> np.ndarray:
    """Mask of the points inside the convex hull of the masked subset. A
    masked point beyond Q1 - f * IQR or Q3 + f * IQR on any axis is left
    out of the hull; fewer than 4 points, or a degenerate triangulation,
    give the mask itself."""
    points = np.asarray(points)
    mask = np.asarray(mask, dtype=bool)
    masked = points[mask]
    if remove_outliers and masked.shape[0] > 0:
        q1 = np.percentile(masked, 25, axis=0)
        q3 = np.percentile(masked, 75, axis=0)
        iqr = q3 - q1
        bad = (masked < (q1 - outlier_factor * iqr)) | (masked > (q3 + outlier_factor * iqr))
        masked = masked[~np.any(bad, axis=1)]
    if masked.shape[0] < 4:
        return mask.copy()
    from scipy.spatial import Delaunay, QhullError

    try:
        tri = Delaunay(masked)
    except (QhullError, ValueError):
        return mask.copy()
    return tri.find_simplex(points) >= 0
