"""Literal NumPy oracles for reference semantics.

Independent, loop-level Python re-statements of the algorithms described in
SURVEY.md (k-strongest filtering `radar_filters.cpp:209-337`, weighted cell
statistics `pointnormal.cpp:7-63`), used only to validate the fixed-shape
JAX implementations against the reference behavior.
"""

from __future__ import annotations

import math

import numpy as np


def kstrongest_oracle(image: np.ndarray, k: int, z_min: int):
    """Per-azimuth k-strongest (intensity >= z_min), ties prefer larger bin.

    Returns list of sorted bin lists per azimuth.
    """
    out = []
    for row in image:
        cand = [(int(v), b) for b, v in enumerate(row) if int(v) >= z_min]
        cand.sort()                      # ascending (intensity, bin)
        kept = cand[-k:] if len(cand) > k else cand
        out.append(sorted(b for _, b in kept))
    return out


def nms_peaks_oracle(image: np.ndarray, kept_bins, w: int = 3):
    """Axial NMS on the k-strongest bins: smoothed score local maxima."""
    a, r = image.shape
    img = image.astype(np.int64)
    peaks = []
    for az in range(a):
        score = {}

        def get_score(b):
            if b not in score:
                s = 0
                for bb in range(b - w, b + w + 1):
                    if 0 <= bb < r:
                        s += int(img[az, bb])
                score[b] = s
            return score[b]

        row_peaks = []
        for b in kept_bins[az]:
            if b < w or b >= r - w:
                continue
            pthis = get_score(b)
            largest = True
            for i in range(1, w + 1):
                if get_score(b - i) > pthis or pthis < get_score(b + i):
                    largest = False
                    break
            if largest:
                row_peaks.append(b)
        peaks.append(row_peaks)
    return peaks


def points_oracle(image: np.ndarray, bins_per_az, range_res: float,
                  min_distance: float):
    """Polar bins -> Cartesian points with the reference conventions."""
    a = image.shape[0]
    min_bin = math.ceil(min_distance / range_res)
    pts = []
    for az, bins in enumerate(bins_per_az):
        theta = (az + 1) / a * 2 * np.pi
        for b in bins:
            if b > min_bin:
                rng = (b + 0.5) * range_res
                pts.append((rng * np.cos(theta), rng * np.sin(theta),
                            float(image[az, b])))
    return np.array(pts).reshape(-1, 3)


def cacfar_oracle(image: np.ndarray, window: int, guard: int,
                  false_alarm_rate: float, range_res: float,
                  static_threshold: float, min_distance: float,
                  max_distance: float):
    """Literal loop-level restatement of
    `AzimuthCACFAR::getFilteredPointCloud` (`cfar.cpp:35-71`) in double
    precision. Returns (x, y, intensity) points, one per detection, with
    the CFAR conventions: range = bin * dr (no half-bin offset), theta =
    (az+1)/A * 2pi; mean windows of squared intensities, trailing
    [max(0, b-g-w), b-g) and forward [b+g, min(R, b+g+w)); a window with
    zero samples yields NaN (0/0) -> never detects."""
    a, r = image.shape
    alpha = (2 * window) * (false_alarm_rate ** (-1.0 / (2 * window)) - 1.0)
    img = image.astype(np.float64)
    pts = []
    for az in range(a):
        theta = (az + 1) / a * 2 * np.pi
        for b in range(r):
            rng = range_res * b
            intensity = img[az, b]
            if not (rng > min_distance and rng < max_distance
                    and intensity > static_threshold):
                continue

            def get_mean(lo, hi):
                s, n = 0.0, 0.0
                for i in range(max(lo, 0), hi):
                    s += img[az, i] ** 2
                    n += 1.0
                return s / n if n > 0 else float("nan")

            t_mean = get_mean(b - guard - window, b - guard)
            f_mean = get_mean(b + guard, min(r, b + guard + window))
            mean = (t_mean + f_mean) / 2.0
            if intensity ** 2 > alpha * mean:   # NaN compares False
                pts.append((rng * np.cos(theta), rng * np.sin(theta),
                            intensity))
    return np.array(pts).reshape(-1, 3)


def cell_oracle(points_xy: np.ndarray, intens: np.ndarray,
                weight_intensity: bool, floor: float = 60.0):
    """Weighted mean / covariance / normal of one cell's samples
    (cell::cell, `pointnormal.cpp:7-63`). Returns dict or None if invalid."""
    n = points_xy.shape[0]
    w = np.maximum(intens - floor, 0.0) if weight_intensity else np.ones(n)
    s = w.sum()
    if s <= 0:
        return None
    wn = w / s
    mean = (wn[:, None] * points_xy).sum(0)
    d = points_xy - mean
    cov = (d * wn[:, None]).T @ d
    evals, evecs = np.linalg.eigh(cov)
    lmin, lmax = evals[0], evals[1]
    normal = evecs[:, 0]
    cond = abs(lmax / lmin) if lmin != 0 else np.inf
    det = lmax * lmin
    valid = (cond <= 10000) and (det > 1e-5) and lmin > 0 and lmax > 0
    if normal @ (0 - mean) < 0:
        normal = -normal
    return dict(mean=mean, cov=cov, normal=normal, lmin=lmin, lmax=lmax,
                valid=valid, planarity=np.log1p(cond / 2.0), nsamples=n)


def voxel_cells_oracle(points_xy: np.ndarray, intens: np.ndarray, res: float,
                       weight_intensity: bool, min_samples: int = 6,
                       downsample_factor: float = 1.0):
    """Full MapPointNormal::ComputeNormals oracle: voxel-grid centroids,
    circular radius search, per-cell statistics. Returns list of cell dicts."""
    leaf = res / downsample_factor
    vox = {}
    for i, p in enumerate(points_xy):
        key = (math.floor(p[0] / leaf), math.floor(p[1] / leaf))
        vox.setdefault(key, []).append(i)
    cells = []
    for key in sorted(vox):
        centroid = points_xy[vox[key]].mean(0)
        d2 = ((points_xy - centroid) ** 2).sum(1)
        idx = np.where(d2 <= res * res)[0]
        if len(idx) < min_samples:
            continue
        c = cell_oracle(points_xy[idx], intens[idx], weight_intensity)
        if c is not None and c["valid"]:
            cells.append(c)
    return cells
