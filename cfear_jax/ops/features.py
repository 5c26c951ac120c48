"""Oriented surface points ("cells"): the core CFEAR feature representation.

Fixed-shape re-design of `MapPointNormal` / `cell`
(`pointnormal.cpp:7-63,265-297`). The reference voxel-downsamples the cloud
(leaf = res/downsample_factor), then for every voxel centroid runs a kd-tree
radius search (r = res) over the full cloud and computes an intensity-weighted
mean / 2x2 covariance / smallest-eigenvector normal per cell.

Here the kd-tree + per-cell loops become three dense array passes:

1. sum points per voxel of a static grid -> per-voxel unweighted
   centroid (the voxel-grid "sample mean" of `pointnormal.cpp:277-280`);
2. for each of the (2*noff+1)^2 neighbor offsets, test every point against
   the neighbor voxel's centroid (exact circular radius test, identical to
   the kd radius search) and sum weighted moments into that voxel's
   accumulator — coordinates are accumulated RELATIVE to the voxel center so
   f32 moments stay well-conditioned;
3. closed-form 2x2 eigendecomposition per voxel (no LAPACK), validity gates
   (`pointnormal.cpp:53-56`), then compaction to a fixed `max_cells` budget.

Weighted statistics match `cell::cell` (`pointnormal.cpp:7-36`):
w_i = max(intensity_i - 60, 0) (or 1), normalized to sum 1;
mean = sum w_i x_i; cov = sum w_i (x_i - mean)(x_i - mean)^T.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cfear_jax.config import CFEARConfig
from cfear_jax.ops.filtering import PointCloud
from cfear_jax.utils import se2


class CellMap(NamedTuple):
    """Fixed-size masked set of oriented surface points (one scan)."""

    mean: jax.Array        # (M, 2) float32 — weighted mean, sensor-local frame
    normal: jax.Array      # (M, 2) float32 — unit normal (toward sensor)
    cov: jax.Array         # (M, 2, 2) float32
    nsamples: jax.Array    # (M,) float32 — points inside the search radius
    planarity: jax.Array   # (M,) float32 — scale_ = log(1 + cond/2)
    valid: jax.Array       # (M,) bool

    @property
    def n(self) -> jax.Array:
        return jnp.sum(self.valid)


def _grid_geometry(cfg: CFEARConfig):
    """Static voxel-grid geometry for the feature stage."""
    leaf = cfg.feature.res / cfg.feature.downsample_factor
    half = int(math.ceil(cfg.radar.max_usable_range / leaf)) + 2
    dim = 2 * half
    # the Morton spatial sort (_morton2) interleaves <=15-bit coordinates
    # and uses 2^30 as its invalid-cell sentinel; fail loudly instead of
    # silently colliding codes on extreme max_usable_range/leaf configs
    if dim > (1 << 15):
        raise ValueError(
            f"voxel grid dim {dim} exceeds the 15-bit Morton-code limit "
            f"(max_usable_range={cfg.radar.max_usable_range}, leaf={leaf}); "
            "increase feature.res or reduce radar.max_usable_range")
    noff = int(math.ceil(cfg.feature.res / leaf))
    return leaf, dim, noff


def _eig2x2_min(a, b, c):
    """Eigen-pair of symmetric [[a, b], [b, c]]: (lmin, lmax, evec_min).

    Closed form; evec picked from the better-conditioned column of
    (A - lmin I)'s adjugate to stay stable when b ~ 0.
    """
    half_tr = 0.5 * (a + c)
    disc = jnp.sqrt(jnp.maximum(0.25 * (a - c) ** 2 + b * b, 0.0))
    lmin = half_tr - disc
    lmax = half_tr + disc
    v1 = jnp.stack([lmin - c, b], -1)       # rows of (A - lmax I) ~ evec of lmin
    v2 = jnp.stack([b, lmin - a], -1)
    n1 = jnp.sum(v1 * v1, -1)
    n2 = jnp.sum(v2 * v2, -1)
    v = jnp.where((n1 >= n2)[..., None], v1, v2)
    vn = jnp.sum(v * v, -1, keepdims=True)
    # degenerate (isotropic) covariance: fall back to x-axis
    v = jnp.where(vn > 1e-20, v * jax.lax.rsqrt(jnp.maximum(vn, 1e-20)),
                  jnp.stack([jnp.ones_like(a), jnp.zeros_like(a)], -1))
    return lmin, lmax, v


def _morton2(ix, iy):
    """Interleave two <=15-bit non-negative int32 coordinates (Morton/Z
    order): bit k of ix lands at position 2k, iy at 2k+1."""
    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v
    return spread(ix) | (spread(iy) << 1)


def budget_points(points: PointCloud, budget: int) -> PointCloud:
    """Row compaction to a fixed point budget (batched: leaves are (B, N, ...)).

    Overflow policy: drop the WEAKEST-intensity points (their feature weight
    max(I-60, 0) is smallest), never an azimuth wedge. This is THE device-side
    budget contract — the native host compaction
    (`native/cfear_io.cpp` filter_frames_host_compact) must match it
    bit-for-bit (tested in tests/test_native_io.py)."""
    key = jnp.where(points.valid, points.intensity, -1.0)
    order = jnp.argsort(-key, axis=-1)[..., :budget]
    # one packed (rows, 5) gather instead of four per-array gathers
    packed = jnp.concatenate(
        [points.xy, points.intensity[..., None],
         points.valid.astype(points.xy.dtype)[..., None],
         points.peak.astype(points.xy.dtype)[..., None]], axis=-1)
    kept = jnp.take_along_axis(packed, order[..., None], axis=-2)
    return PointCloud(
        xy=kept[..., 0:2],
        intensity=kept[..., 2],
        valid=kept[..., 3] > 0.5,
        peak=kept[..., 4] > 0.5)


def _segment_plan(seg, num_segments: int):
    """Sort plan for `_segment_sum_lanes`: seg (B, N) int32 segment ids in
    [0, num_segments]; id num_segments marks rows to drop. Returns (flat
    row order (B*N,), segment-start flags of the sorted rows (B, N), flat
    destination of each sorted row (B*N,): lane * num_segments + id for the
    last row of a segment, an index past the output for every other row)."""
    b, n = seg.shape
    order = jnp.argsort(seg, axis=-1, stable=True)
    seg_s = jnp.take_along_axis(seg, order, axis=-1)
    edge = seg_s[:, 1:] != seg_s[:, :-1]
    ones = jnp.ones((b, 1), bool)
    start = jnp.concatenate([ones, edge], -1)
    last = jnp.concatenate([edge, ones], -1)
    lane = jnp.arange(b, dtype=jnp.int32)[:, None]
    row = lane * n + jnp.arange(n, dtype=jnp.int32)[None]
    # rows that end no segment get distinct out-of-range slots (dropped)
    dst = jnp.where(last & (seg_s < num_segments), lane * num_segments + seg_s,
                    b * num_segments + row)
    return (lane * n + order).reshape(b * n), start, dst.reshape(b * n)


def _segment_sum_lanes(data, plan, num_segments: int):
    """Per-lane segment sum with a fixed order of additions: data (B, N, C)
    -> (B, num_segments, C).

    `jax.ops.segment_sum` is a scatter-add, which the GPU runs with atomics:
    the order in which rows land, and so the last bits of every sum, change
    from run to run. Here each lane's rows are sorted by segment (stable), a
    segmented inclusive scan along the lane's own axis sums each segment,
    and each segment's total (its last row) is written once. The order of
    every addition depends only on the lane's own rows, so a lane gives the
    same bits from run to run, alone and in a batch."""
    b, n, c = data.shape
    order, start, dst = plan
    rows = data.reshape(b * n, c)[order].reshape(b, n, c)

    def add(lo, hi):
        (f_lo, v_lo), (f_hi, v_hi) = lo, hi
        return f_lo | f_hi, jnp.where(f_hi[..., None], v_hi, v_lo + v_hi)

    _, csum = jax.lax.associative_scan(add, (start, rows), axis=1)
    out = jnp.zeros((b * num_segments, c), data.dtype).at[dst].set(
        csum.reshape(b * n, c), mode="drop", unique_indices=True)
    return out.reshape(b, num_segments, c)


def compute_cells(points: PointCloud, cfg: CFEARConfig) -> CellMap:
    """Point cloud -> oriented surface points (sensor-local frame)."""
    batched = compute_cells_batched(
        jax.tree.map(lambda a: a[None], points), cfg)
    return jax.tree.map(lambda a: a[0], batched)


def compute_cells_batched(points: PointCloud, cfg: CFEARConfig) -> CellMap:
    """Batched oriented-surface-point extraction: leaves carry (B, N, ...).

    Bit-identical per-lane results to `compute_cells` on each lane alone
    (`_segment_sum_lanes` sums in a per-lane order), with ONE segment sum
    per stage and ONE neighborhood gather for all lanes.
    """
    feat = cfg.feature
    leaf, dim, noff = _grid_geometry(cfg)
    ncells = dim * dim
    p = feat.point_budget
    if p and p < points.xy.shape[1]:
        # row compaction: every sort/gather below is row-bound, and the
        # (A, k) candidate array carries many invalid slots
        points = budget_points(points, p)

    xy = points.xy                                            # (B, N, 2)
    b, n_pts = xy.shape[0], xy.shape[1]
    valid = points.valid                                      # (B, N)
    lane = jnp.arange(b, dtype=jnp.int32)[:, None]            # (B, 1)

    # --- stage 1: voxel centroids (unweighted, like pcl::VoxelGrid) ---
    vidx = jnp.floor(xy / leaf).astype(jnp.int32) + dim // 2
    in_grid = valid & jnp.all((vidx >= 0) & (vidx < dim), axis=-1)
    vid = vidx[..., 0] * dim + vidx[..., 1]                   # (B, N)
    # both stages sum over each point's own voxel: one sort plan serves both
    plan = _segment_plan(jnp.where(in_grid, vid, ncells), ncells)
    ones = in_grid.astype(jnp.float32)
    # one fused segment sum for [count, sum_x, sum_y]
    s1 = _segment_sum_lanes(
        jnp.concatenate([ones[..., None], xy * ones[..., None]], -1),
        plan, ncells)
    cnt_vox, sum_vox = s1[..., 0], s1[..., 1:3]               # (B, ncells, .)
    centroid = sum_vox / jnp.maximum(cnt_vox, 1.0)[..., None]
    occupied = cnt_vox >= 1.0

    # --- stage 2: weighted moments per candidate cell ---
    if feat.weight_intensity:
        w_pt = jnp.maximum(points.intensity - feat.intensity_floor, 0.0)
    else:
        w_pt = jnp.ones_like(points.intensity)

    offsets = [(dx, dy) for dx in range(-noff, noff + 1)
               for dy in range(-noff, noff + 1)]
    # Pre-pack each voxel's neighborhood (centroid x/y + occupancy per
    # offset) with dense rolls so the per-offset loop below needs NO gathers
    # — ONE (B*N, 3*n_off) gather replaces 3 gathers per offset. Rolled
    # wrap-around entries are masked by the `ok` bounds test.
    cgrid = jnp.concatenate(
        [centroid.reshape(b, dim, dim, 2),
         occupied.reshape(b, dim, dim, 1).astype(jnp.float32)], -1)
    nb = jnp.concatenate(
        [jnp.roll(cgrid, (-dx, -dy), (1, 2)) for dx, dy in offsets], -1)
    vid_c = jnp.clip(jnp.where(in_grid, vid, ncells), 0, ncells - 1)
    nb_pt = nb.reshape(b * ncells, 3 * len(offsets))[
        (lane * ncells + vid_c).reshape(b * n_pts)]           # (B*N, 27)
    nb_pt = nb_pt.reshape(b, n_pts, 3 * len(offsets))

    # Per-offset membership masks (per-point circular gate vs the TARGET
    # voxel's centroid). The sum itself targets each point's OWN voxel:
    # for a fixed offset the target id is own_id + const, so the per-offset
    # sum equals the own-voxel sum ROLLED by the offset on the dense grid —
    # ONE (B*N)-row segment sum with 9x7 masked columns replaces the
    # (9*B*N)-row one. Moments
    # are accumulated about the OWN voxel center and shifted to the target
    # center in closed form afterwards (rel_t = rel_own - offset*leaf).
    own_cx = (vidx[..., 0].astype(jnp.float32) - dim // 2 + 0.5) * leaf
    own_cy = (vidx[..., 1].astype(jnp.float32) - dim // 2 + 0.5) * leaf
    rx = xy[..., 0] - own_cx                              # (B, N)
    ry = xy[..., 1] - own_cy
    base = jnp.stack(
        [jnp.ones_like(w_pt),           # raw sample count
         w_pt,                          # S0
         w_pt * rx, w_pt * ry,          # S1 (own-center coordinates)
         w_pt * rx * rx, w_pt * rx * ry, w_pt * ry * ry],  # S2
        axis=-1)                                          # (B, N, 7)

    mem_cols = []
    for oi, (dx, dy) in enumerate(offsets):
        tx = vidx[..., 0] + dx
        ty = vidx[..., 1] + dy
        ok = in_grid & (tx >= 0) & (tx < dim) & (ty >= 0) & (ty < dim)
        c = nb_pt[..., 3 * oi:3 * oi + 2]
        occ = nb_pt[..., 3 * oi + 2] > 0.5
        d2 = jnp.sum((xy - c) ** 2, axis=-1)
        mem_cols.append(ok & occ & (d2 <= feat.res * feat.res))
    mem = jnp.stack(mem_cols, -1).astype(jnp.float32)     # (B, N, n_off)

    data = (mem[..., :, None] * base[..., None, :]).reshape(
        b, n_pts, len(offsets) * 7)
    acc_own = _segment_sum_lanes(data, plan, ncells).reshape(
        b, dim, dim, len(offsets), 7)

    # roll each offset's grid onto its target voxel and shift the moment
    # origin from the own center to the target center (d = offset * leaf)
    acc = jnp.zeros((b, dim, dim, 7), jnp.float32)
    for oi, (dx, dy) in enumerate(offsets):
        g = jnp.roll(acc_own[..., oi, :], (dx, dy), (1, 2))
        dxl, dyl = dx * leaf, dy * leaf
        cnt, s0_, s1x, s1y, sxx, sxy, syy = [g[..., i] for i in range(7)]
        acc = acc + jnp.stack(
            [cnt, s0_,
             s1x - dxl * s0_,
             s1y - dyl * s0_,
             sxx - 2.0 * dxl * s1x + dxl * dxl * s0_,
             sxy - dxl * s1y - dyl * s1x + dxl * dyl * s0_,
             syy - 2.0 * dyl * s1y + dyl * dyl * s0_], -1)
    acc = acc.reshape(b, ncells, 7)
    nsamp, s0 = acc[..., 0], acc[..., 1]

    safe_s0 = jnp.maximum(s0, 1e-12)
    mx, my = acc[..., 2] / safe_s0, acc[..., 3] / safe_s0
    cxx = acc[..., 4] / safe_s0 - mx * mx
    cxy = acc[..., 5] / safe_s0 - mx * my
    cyy = acc[..., 6] / safe_s0 - my * my

    # static voxel centers (constants folded by XLA)
    ii = jnp.arange(dim, dtype=jnp.float32) - dim // 2 + 0.5
    vc_x = jnp.repeat(ii, dim) * leaf           # (ncells,)
    vc_y = jnp.tile(ii, dim) * leaf

    # --- stage 3: normals + validity gates (`pointnormal.cpp:37-62`) ---
    lmin, lmax, nvec = _eig2x2_min(cxx, cxy, cyy)
    cond = jnp.abs(lmax / jnp.where(lmin == 0.0, 1e-30, lmin))
    det = lmax * lmin
    cell_ok = (
        occupied
        & (nsamp >= feat.min_samples)
        & (s0 > 0.0)
        & (cond <= feat.cond_max)
        & (det > feat.det_min)
        & (lmin > 0.0)
        & (lmax > 0.0)
    )
    mean = jnp.stack([mx + vc_x, my + vc_y], -1)
    # flip normal toward the sensor origin (`pointnormal.cpp:59-61`)
    flip = jnp.sum(nvec * (0.0 - mean), -1) < 0.0
    nvec = jnp.where(flip[..., None], -nvec, nvec)
    planarity = jnp.log1p(cond / 2.0)

    # --- compaction to the fixed cell budget ---
    ib = jnp.broadcast_to(jnp.arange(ncells, dtype=jnp.int32)[None],
                          (b, ncells))
    return _finalize_cells(mean, nvec, cxx, cxy, cyy, nsamp, planarity,
                           cell_ok, ib // dim, ib % dim, cfg)


def _finalize_cells(mean, nvec, cxx, cxy, cyy, nsamp, planarity, cell_ok,
                    ix, iy, cfg: CFEARConfig) -> CellMap:
    """Shared compaction tail: candidate cell rows -> fixed-budget CellMap.

    Valid cells first; on overflow keep the MOST-SUPPORTED cells (largest
    nsamples) rather than a spatial band of voxel ids. All per-cell
    outputs are packed into ONE (B, rows, 12) buffer first so the
    compaction pays a single (B*m)-row gather instead of many. The
    voxel indices (ix, iy) ride two pack columns (< 2^15, exact in f32)
    for the optional Morton re-sort.
    """
    feat = cfg.feature
    m = feat.max_cells
    order = jnp.argsort(
        -jnp.where(cell_ok, nsamp + 1.0, 0.0), axis=-1)
    take = order[..., :m]                                 # (B, m)

    packed = jnp.stack(
        [mean[..., 0], mean[..., 1], nvec[..., 0], nvec[..., 1],
         cxx, cxy, cyy, nsamp, planarity,
         cell_ok.astype(mean.dtype),
         ix.astype(mean.dtype), iy.astype(mean.dtype)],
        axis=-1)                                          # (B, rows, 12)
    kept = jnp.take_along_axis(packed, take[..., None], axis=1)
    kept_valid = kept[..., 9] > 0.5

    if feat.spatial_sort:
        # re-order the KEPT cells by Morton code of their voxel index
        # (valid first) so contiguous cell tiles are compact spatial blobs
        # — the block-sparse association kernel skips (src-tile, tar-tile)
        # pairs by bounding box, which needs this coherence. Set-semantics
        # preserved: same cells, different order.
        code = _morton2(kept[..., 10].astype(jnp.int32),
                        kept[..., 11].astype(jnp.int32))
        skey = jnp.where(kept_valid, code, jnp.int32(2 ** 30))
        order2 = jnp.argsort(skey, axis=-1, stable=True)
        kept = jnp.take_along_axis(kept, order2[..., None], axis=1)
        kept_valid = kept[..., 9] > 0.5
    vmask = kept_valid[..., None]
    cov = jnp.stack(
        [jnp.stack([kept[..., 4], kept[..., 5]], -1),
         jnp.stack([kept[..., 5], kept[..., 6]], -1)], -2)
    return CellMap(
        mean=jnp.where(vmask, kept[..., 0:2], 0.0),
        normal=jnp.where(vmask, kept[..., 2:4], 0.0),
        cov=jnp.where(vmask[..., None], cov, 0.0),
        nsamples=jnp.where(kept_valid, kept[..., 7], 0.0),
        planarity=jnp.where(kept_valid, kept[..., 8], 0.0),
        valid=kept_valid,
    )


def compute_raw_cells(points: PointCloud, cfg: CFEARConfig) -> CellMap:
    """"use_raw_pointcloud" ablation: one identity cell per filtered point.

    Mirrors `cell::GetIdentityCell` (`pointnormal.h:62,79-81`): mean = point,
    cov = 0.1*I, normal = (1, 0), planarity scale = 1, Nsamples = 1. The
    fixed cell budget keeps the first `max_cells_raw` valid points.
    """
    m = cfg.feature.max_cells_raw
    order = jnp.argsort(~points.valid, stable=True)[:m]
    valid = points.valid[order]
    xy = jnp.where(valid[:, None], points.xy[order], 0.0)
    eye = jnp.broadcast_to(0.1 * jnp.eye(2, dtype=xy.dtype), (m, 2, 2))
    normal = jnp.broadcast_to(jnp.asarray([1.0, 0.0], xy.dtype), (m, 2))
    ones = jnp.ones((m,), xy.dtype)
    return CellMap(mean=xy, normal=jnp.where(valid[:, None], normal, 0.0),
                   cov=jnp.where(valid[:, None, None], eye, 0.0),
                   nsamples=jnp.where(valid, ones, 0.0),
                   planarity=jnp.where(valid, ones, 0.0),
                   valid=valid)


def transform_cells(cells: CellMap, pose) -> CellMap:
    """Rigid-transform a cell map by an SE(2) pose.

    Equivalent of `cell::TransformCopy` (`pointnormal.cpp:515-529`) with the
    mathematically correct covariance rotation R Sigma R^T (the reference's
    line 517 contains a typo'd `R*T*cov_*R.transpose()`; see SURVEY.md §2.1).
    """
    R = se2.rotmat(pose[..., 2])
    mean = se2.transform(pose, cells.mean)
    normal = se2.rotate(pose, cells.normal)
    cov = jnp.einsum("...ij,...njk,...lk->...nil", R, cells.cov, R)
    return cells._replace(mean=mean, normal=normal, cov=cov)


def compensate_cells(cells: CellMap, tmot, ccw: bool) -> CellMap:
    """Motion-compensate cell means/normals by per-cell relative scan time.

    Equivalent of `MapPointNormal::Compensate` (`pointnormal.cpp:113-133`).
    """
    d = se2.rel_timestamp(cells.mean, ccw)
    ang = d * tmot[..., None, 2]
    c, s = jnp.cos(ang), jnp.sin(ang)
    R = jnp.stack([jnp.stack([c, -s], -1), jnp.stack([s, c], -1)], -2)
    mean = jnp.einsum("...nij,...nj->...ni", R, cells.mean) \
        + d[..., None] * tmot[..., None, :2]
    normal = jnp.einsum("...nij,...nj->...ni", R, cells.normal)
    cov = jnp.einsum("...nij,...njk,...nlk->...nil", R, cells.cov, R)
    return cells._replace(mean=mean, normal=normal, cov=cov)
