"""Scan-to-multi-keyframe registration as a batched IRLS Gauss-Newton/LM solve.

Fixed-shape re-design of `n_scan_normal_reg::Register`
(`n_scan_normal.cpp:82-187`). The reference builds a Ceres problem per
association iteration (kd-tree 1-NN association + autodiff cost functors +
trust-region LM). Here:

- association is an EXACT brute-force 1-NN: a dense (M_src, M_tar)
  squared-distance matrix and an argmin over targets (or the block-sparse
  kernel of `ops/pallas_assoc.py`) — same semantics as the reference's
  sorted kd 1-NN (`pointnormal.cpp:238-254`), no tie-break drift;
- the Gauss-Newton normal equations are 3x3 (only the newest scan's pose is
  free — `incremental_last_to_previous`, `registration.cpp:18-27`), assembled
  as masked reductions over all (keyframe, cell) pairs and solved in closed
  form;
- the inner Levenberg-Marquardt loop replicates Ceres' trust-region strategy
  (radius update by max(1/3, 1-(2*ratio-1)^3), step acceptance at
  min_relative_decrease=1e-3, function_tolerance stop);
- the outer association loop replicates the reference's convergence /
  rollback rules (`n_scan_normal.cpp:102-159`): score-increase rollback,
  relative improvement < 1e-5, inner relative_decrease < 1e-5 or a zero-step
  solve; min 3, max 8 iterations.

Cost metrics P2L / P2P / P2D with Huber-family robust losses and
similarity-based residual weighting reproduce `n_scan_normal.h:87-404` and
`registration.cpp:67-97`. Everything is fixed-shape, jit- and vmap-friendly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from cfear_jax.config import CFEARConfig
from cfear_jax.ops import losses
from cfear_jax.ops.features import CellMap
from cfear_jax.utils import runtime, se2


class Associations(NamedTuple):
    """Fixed-shape association set: one slot per (keyframe, source cell)."""

    tar_idx: jax.Array    # (S, M) int32 — nearest target cell per source cell
    weight: jax.Array     # (S, M) float32 — association weight (0 where invalid)
    valid: jax.Array      # (S, M) bool


class RegistrationResult(NamedTuple):
    pose: jax.Array        # (3,) refined pose of the newest scan
    cov: jax.Array         # (3, 3) Censi-scaled covariance [x, y, yaw]
    success: jax.Array     # bool — enough residuals & solution usable
    score: jax.Array       # final cost / num residuals (`n_scan_normal.cpp:166`)
    final_cost: jax.Array  # Ceres-convention total cost (0.5 * sum w rho)
    num_assoc: jax.Array   # int32 — surviving associations
    iterations: jax.Array  # int32 — outer association iterations executed


# ---------------------------------------------------------------------------
# association
# ---------------------------------------------------------------------------

def _bucket_geometry(cfg: CFEARConfig):
    """Static bucket grid: bin size = the largest search radius (the
    coarse-to-fine first iteration uses 2 * assoc_radius), so the exact 1-NN
    within radius is always inside the 3x3 bucket neighborhood."""
    bin_size = 2.0 * cfg.registration.assoc_radius
    half = int(math.ceil(cfg.radar.max_usable_range / bin_size)) + 2
    return bin_size, 2 * half


def build_buckets(cells: CellMap, cfg: CFEARConfig) -> jax.Array:
    """Bucket table over one scan's cell means: (G*G*B + 1,) int32 of cell
    indices, -1 where empty (last slot is the overflow sink). Cells never
    move in their local frame, so the table is built once per scan."""
    bin_size, g = _bucket_geometry(cfg)
    b = cfg.registration.bucket_capacity
    m = cells.mean.shape[0]
    bi = jnp.floor(cells.mean / bin_size).astype(jnp.int32) + g // 2
    in_grid = cells.valid & jnp.all((bi >= 0) & (bi < g), axis=-1)
    bid = jnp.where(in_grid, bi[:, 0] * g + bi[:, 1], g * g)
    order = jnp.argsort(bid)
    sorted_bid = bid[order]
    # rank within equal-bid run
    first = jnp.searchsorted(sorted_bid, sorted_bid, side="left")
    rank = jnp.arange(m) - first
    slot = jnp.where((rank < b) & (sorted_bid < g * g),
                     sorted_bid * b + rank, g * g * b)
    table = jnp.full((g * g * b + 1,), -1, jnp.int32)
    return table.at[slot].set(order.astype(jnp.int32))


def _associate_grid(cells_i: CellMap, table_i, t_rel, src: CellMap,
                    valid_i, radius, cfg: CFEARConfig, cos_gate):
    """Exact 1-NN via 3x3 bucket lookup (candidates gathered per source)."""
    reg = cfg.registration
    bin_size, g = _bucket_geometry(cfg)
    b = reg.bucket_capacity
    src_mean_t = se2.transform(t_rel, src.mean)               # (M, 2)
    src_norm_t = se2.rotate(t_rel, src.normal)
    bi = jnp.floor(src_mean_t / bin_size).astype(jnp.int32) + g // 2
    cand_list = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            tx = bi[:, 0] + dx
            ty = bi[:, 1] + dy
            ok = (tx >= 0) & (tx < g) & (ty >= 0) & (ty < g)
            base = jnp.where(ok, (tx * g + ty) * b, g * g * b)
            cand_list.append(base[:, None] + jnp.arange(b)[None, :])
    cand = jnp.concatenate(cand_list, axis=1)                 # (M, 9B)
    cand = jnp.minimum(cand, g * g * b)                       # overflow sink
    idx = table_i[cand]                                       # (M, 9B) cell ids
    cand_ok = idx >= 0
    idx_safe = jnp.maximum(idx, 0)
    tmean = cells_i.mean[idx_safe]                            # (M, 9B, 2)
    d2 = jnp.sum((src_mean_t[:, None, :] - tmean) ** 2, -1)
    d2 = jnp.where(cand_ok & cells_i.valid[idx_safe], d2, jnp.inf)
    j = jnp.argmin(d2, axis=1)
    nn = jnp.take_along_axis(idx_safe, j[:, None], axis=1)[:, 0]
    nn_d2 = jnp.take_along_axis(d2, j[:, None], axis=1)[:, 0]
    sim_dir = jnp.maximum(jnp.sum(src_norm_t * cells_i.normal[nn], -1), 0.0)
    ok = (src.valid & valid_i & (nn_d2 < radius * radius)
          & (sim_dir > cos_gate))
    w = losses.association_weight(
        reg.weight_opt, src.nsamples, cells_i.nsamples[nn], sim_dir,
        src.planarity, cells_i.planarity[nn])
    return nn.astype(jnp.int32), jnp.where(ok, w, 0.0), ok


def associate(kf_cells: CellMap, kf_poses, kf_valid, src: CellMap, src_pose,
              radius, cfg: CFEARConfig, buckets=None) -> Associations:
    """1-NN association of source cells to each keyframe's cells.

    Mirrors `AddScanPairCost` (`n_scan_normal.cpp:215-263`): source means are
    moved into each keyframe's local frame with T_tar^{-1} T_src, matched to
    the exact nearest target cell, gated by `radius` and by normal agreement
    dot(R_rel n_src, n_tar) > cos(30 deg), max one correspondence per source
    cell; weights from (N_src, N_tar, sim_dir, planarity) per the configured
    weight option.

    Two equivalent backends: "dense" builds the (M_src, M_tar) distance
    matrix; "grid" looks up the 3x3 neighborhood of a per-keyframe bucket
    table — identical nearest neighbors (bucket bin >= search radius).
    """
    reg = cfg.registration
    cos_gate = math.cos(math.radians(reg.angle_outlier_deg))

    if reg.assoc_method == "grid":
        if buckets is None:
            buckets = jax.vmap(lambda c: build_buckets(c, cfg))(kf_cells)

        def per_keyframe_grid(cells_i, table_i, pose_i, valid_i):
            t_rel = se2.relative(pose_i, src_pose)
            return _associate_grid(cells_i, table_i, t_rel, src, valid_i,
                                   radius, cfg, cos_gate)

        tar_idx, weight, valid = jax.vmap(per_keyframe_grid)(
            kf_cells, buckets, kf_poses, kf_valid)
        return Associations(tar_idx, weight, valid)

    def per_keyframe(cells_i: CellMap, pose_i, valid_i):
        t_rel = se2.relative(pose_i, src_pose)
        src_mean_t = se2.transform(t_rel, src.mean)          # (M, 2)
        src_norm_t = se2.rotate(t_rel, src.normal)
        nn, nn_d2 = nn_dense(src_mean_t, cells_i.mean[None],
                             cells_i.valid[None])
        nn, nn_d2 = nn[0], nn_d2[0]                           # (M,)
        sim_dir = jnp.maximum(
            jnp.sum(src_norm_t * cells_i.normal[nn], -1), 0.0)
        ok = (src.valid & valid_i & cells_i.valid[nn]
              & (nn_d2 < radius * radius) & (sim_dir > cos_gate))
        w = losses.association_weight(
            reg.weight_opt, src.nsamples, cells_i.nsamples[nn], sim_dir,
            src.planarity, cells_i.planarity[nn])
        return nn.astype(jnp.int32), jnp.where(ok, w, 0.0), ok

    tar_idx, weight, valid = jax.vmap(per_keyframe)(kf_cells, kf_poses, kf_valid)
    return Associations(tar_idx, weight, valid)


def _world_attrs(kf_cells: CellMap, kf_poses, cfg: CFEARConfig):
    """All keyframe cells pre-transformed into the registration frame ONCE.

    The keyframe poses are fixed during a register() call
    (`incremental_last_to_previous`, `registration.cpp:18-27`), so the
    per-iteration association loop only needs gathers from this packed
    (S, M, D) attribute matrix instead of re-transforming gathered cells
    every iteration. Columns: [mx, my, nx, ny, nsamples, planarity, valid]
    (+ [l11, l21, l22] sqrt-information for P2D)."""
    reg = cfg.registration

    def per_kf(cells_i: CellMap, pose_i):
        mean = se2.transform(pose_i, cells_i.mean)
        normal = se2.rotate(pose_i, cells_i.normal)
        cols = [mean, normal, cells_i.nsamples[:, None],
                cells_i.planarity[:, None],
                cells_i.valid.astype(mean.dtype)[:, None]]
        if reg.cost == "P2D":
            R = se2.rotmat(pose_i[2])
            cov_w = jnp.einsum("ij,njk,lk->nil", R, cells_i.cov, R)
            cov_w = (cov_w + reg.regularization
                     * jnp.eye(2, dtype=cov_w.dtype)) * reg.cov_scale
            det = (cov_w[:, 0, 0] * cov_w[:, 1, 1]
                   - cov_w[:, 0, 1] * cov_w[:, 1, 0])
            det = jnp.maximum(det, 1e-20)
            ia = cov_w[:, 1, 1] / det
            ib = -cov_w[:, 0, 1] / det
            ic = cov_w[:, 0, 0] / det
            l11, l21, l22 = _chol2_lower(ia, ib, ic)
            cols.append(jnp.stack([l11, l21, l22], -1))
        return jnp.concatenate(cols, axis=-1)

    return jax.vmap(per_kf)(kf_cells, kf_poses)


def _tgt_from_attrs(g, cfg: CFEARConfig):
    """Attribute rows (S, M, D) -> the target-terms dict of `_target_terms`."""
    tgt = {"mean": g[..., 0:2], "normal": g[..., 2:4]}
    if cfg.registration.cost == "P2D":
        tgt["sqrt_info"] = g[..., 7:10]
    return tgt


def nn_dense(src_xy, tar_xy, tar_valid):
    """Dense 1-NN of (M_src, 2) points among each keyframe's (S, M_tar, 2)
    valid targets in XLA: (nn (S, M_src) int32, d2 (S, M_src)).

    Difference form (sx - tx)^2 + (sy - ty)^2: XLA fuses it into the
    min/argmin reduction without materializing the distance matrix, and it
    has none of the |s|^2 + |t|^2 - 2 s.t form's cancellation error at
    100 m ranges (which flips nearest neighbors)."""
    d = src_xy[None, :, None, :] - tar_xy[:, None, :, :]      # (S, M, M, 2)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    d2 = jnp.where(tar_valid[:, None, :], d2, jnp.inf)
    return jnp.argmin(d2, axis=-1).astype(jnp.int32), jnp.min(d2, axis=-1)


def _associate_world(attrs, src: CellMap, src_pose, kf_valid, radius,
                     cfg: CFEARConfig, cos_gate, method: str = "dense"):
    """Exact dense 1-NN association in the shared registration frame.

    Semantically identical to `associate(...)` with the dense backend
    (distances are invariant to the rigid change of frame), but the source
    scan is transformed once (not once per keyframe) and ALL per-target
    quantities come from a single (M, D) gather of the pre-packed world
    attributes. With `method="sparse"` the distance+argmin runs as the
    block-sparse kernel (`ops/pallas_assoc.py`) — identical nearest
    neighbors on every row the radius gate keeps.
    Returns (Associations, target-terms dict)."""
    reg = cfg.registration
    src_mean_w = se2.transform(src_pose, src.mean)            # (M, 2)
    src_norm_w = se2.rotate(src_pose, src.normal)

    if method == "sparse":
        from cfear_jax.ops import pallas_assoc
        tar_valid = (attrs[..., 6] > 0.5) & kf_valid[:, None]
        nn_all, d2_all = pallas_assoc.nn_min(
            src_mean_w, src.valid, attrs[..., 0:2], tar_valid, radius)
    else:
        nn_all, d2_all = nn_dense(src_mean_w, attrs[..., 0:2],
                                  attrs[..., 6] > 0.5)

    # attribute lookup at the nearest neighbors: ONE flat gather with the
    # keyframe axis collapsed into the row index
    s_kf, m_tar = attrs.shape[0], attrs.shape[1]
    flat_idx = nn_all + (jnp.arange(s_kf, dtype=jnp.int32) * m_tar)[:, None]
    g = attrs.reshape(s_kf * m_tar, attrs.shape[-1])[
        flat_idx.reshape(-1)].reshape(s_kf, nn_all.shape[1], -1)
    sim_dir = jnp.maximum(
        jnp.sum(src_norm_w[None] * g[..., 2:4], -1), 0.0)
    ok = (src.valid[None] & kf_valid[:, None] & (g[..., 6] > 0.5)
          & (d2_all < radius * radius) & (sim_dir > cos_gate))
    w = losses.association_weight(
        reg.weight_opt, src.nsamples[None], g[..., 4], sim_dir,
        src.planarity[None], g[..., 5])
    return (Associations(nn_all.astype(jnp.int32), jnp.where(ok, w, 0.0), ok),
            _tgt_from_attrs(g, cfg))


# ---------------------------------------------------------------------------
# residual / normal-equation assembly
# ---------------------------------------------------------------------------

def _chol2_lower(a, b, c):
    """Lower Cholesky of SPD [[a, b], [b, c]] (batched scalars)."""
    l11 = jnp.sqrt(jnp.maximum(a, 1e-30))
    l21 = b / l11
    l22 = jnp.sqrt(jnp.maximum(c - l21 * l21, 1e-30))
    return l11, l21, l22


def _solve3(A, b, eps=1e-30):
    """Closed-form 3x3 solve via the adjugate — pure arithmetic that XLA can
    fuse, instead of a LAPACK-style factorization kernel (hot path: one solve
    per LM iteration)."""
    a00, a01, a02 = A[0, 0], A[0, 1], A[0, 2]
    a10, a11, a12 = A[1, 0], A[1, 1], A[1, 2]
    a20, a21, a22 = A[2, 0], A[2, 1], A[2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) > eps, det, eps)
    x0 = (c00 * b[0] + c01 * b[1] + c02 * b[2]) * inv_det
    x1 = (c10 * b[0] + c11 * b[1] + c12 * b[2]) * inv_det
    x2 = (c20 * b[0] + c21 * b[1] + c22 * b[2]) * inv_det
    return jnp.stack([x0, x1, x2])


def _inv3(A, eps=1e-30):
    """Closed-form 3x3 inverse (adjugate/det)."""
    cols = [_solve3(A, jnp.eye(3, dtype=A.dtype)[:, i], eps) for i in range(3)]
    return jnp.stack(cols, axis=1)


def _target_terms(kf_cells: CellMap, kf_poses, assoc: Associations,
                  cfg: CFEARConfig):
    """Per-association target quantities in the world frame (fixed per outer
    iteration — the "efficient" pre-transformed functors of
    `n_scan_normal.h:180-255`)."""
    reg = cfg.registration

    def per_keyframe(cells_i: CellMap, pose_i, idx):
        mean = se2.transform(pose_i, cells_i.mean[idx])       # (M, 2)
        normal = se2.rotate(pose_i, cells_i.normal[idx])
        out = {"mean": mean, "normal": normal}
        if reg.cost == "P2D":
            R = se2.rotmat(pose_i[2])
            cov_w = jnp.einsum("ij,njk,lk->nil", R, cells_i.cov[idx], R)
            cov_w = (cov_w + reg.regularization
                     * jnp.eye(2, dtype=cov_w.dtype)) * reg.cov_scale
            # sqrt information: lower Cholesky of cov^{-1}
            # (`n_scan_normal.cpp:292-297`)
            det = (cov_w[:, 0, 0] * cov_w[:, 1, 1]
                   - cov_w[:, 0, 1] * cov_w[:, 1, 0])
            det = jnp.maximum(det, 1e-20)
            ia = cov_w[:, 1, 1] / det
            ib = -cov_w[:, 0, 1] / det
            ic = cov_w[:, 0, 0] / det
            l11, l21, l22 = _chol2_lower(ia, ib, ic)
            out["sqrt_info"] = jnp.stack([l11, l21, l22], -1)  # (M, 3)
        return out

    return jax.vmap(per_keyframe)(kf_cells, kf_poses, assoc.tar_idx)


def _residuals(pose, src: CellMap, tgt, cfg: CFEARConfig):
    """Residuals r and Jacobians J = dr/d[x,y,theta] for all associations.

    Returns (r, J) with shapes (S, M, D) and (S, M, D, 3); D = 1 for P2L,
    2 for P2P/P2D. Cost functors: `n_scan_normal.h:134-361`.
    """
    reg = cfg.registration
    c, s = jnp.cos(pose[2]), jnp.sin(pose[2])
    R = jnp.array([[c, -s], [s, c]])
    dR = jnp.array([[-s, -c], [c, -s]])
    src_w = src.mean @ R.T + pose[:2]                         # (M, 2)
    dsrc_dth = src.mean @ dR.T                                # (M, 2)

    diff = src_w[None, :, :] - tgt["mean"]                    # (S, M, 2)
    if reg.cost == "P2L":
        n = tgt["normal"]                                     # (S, M, 2)
        r = jnp.sum(diff * n, -1, keepdims=True)              # (S, M, 1)
        jth = jnp.sum(n * dsrc_dth[None], -1)
        J = jnp.stack([n[..., 0], n[..., 1], jth], -1)[..., None, :]
        return r, J
    # P2P / P2D share the 2-D difference residual
    jx = jnp.broadcast_to(jnp.array([1.0, 0.0]), diff.shape)
    jy = jnp.broadcast_to(jnp.array([0.0, 1.0]), diff.shape)
    jth = jnp.broadcast_to(dsrc_dth[None], diff.shape)
    J = jnp.stack([jx, jy, jth], -1)                          # (S, M, 2, 3)
    if reg.cost == "P2D":
        l11, l21, l22 = (tgt["sqrt_info"][..., 0], tgt["sqrt_info"][..., 1],
                         tgt["sqrt_info"][..., 2])
        r0 = l11 * diff[..., 0]
        r1 = l21 * diff[..., 0] + l22 * diff[..., 1]
        r = jnp.stack([r0, r1], -1)
        J0 = l11[..., None] * J[..., 0, :]
        J1 = l21[..., None] * J[..., 0, :] + l22[..., None] * J[..., 1, :]
        J = jnp.stack([J0, J1], -2)
        return r, J
    return diff, J


def _cost_only(pose, src, tgt, assoc: Associations, cfg: CFEARConfig,
               guess, soft_scale, soft_sqrt_info):
    """Total robust cost without gradient/Hessian (cheap trial evaluation)."""
    reg = cfg.registration
    r, _ = _residuals(pose, src, tgt, cfg)
    s = jnp.sum(r * r, -1)
    rho_s, _ = losses.rho(s, reg.loss, reg.loss_limit)
    w = assoc.weight * assoc.valid
    cost = 0.5 * jnp.sum(w * rho_s)
    if reg.soft_constraint and soft_sqrt_info is not None:
        d = pose - guess
        d = d.at[2].set(se2.normalize_angle(d[2]))
        rs = soft_scale * (soft_sqrt_info @ d)
        cost = cost + 0.5 * jnp.sum(rs * rs)
    return cost


def _cost_grad_hess(pose, src, tgt, assoc: Associations, cfg: CFEARConfig,
                    guess, soft_scale, soft_sqrt_info):
    """Total robust cost, gradient and IRLS Gauss-Newton Hessian (3x3)."""
    reg = cfg.registration
    r, J = _residuals(pose, src, tgt, cfg)
    s = jnp.sum(r * r, -1)                                    # (S, M)
    rho_s, drho = losses.rho(s, reg.loss, reg.loss_limit)
    w = assoc.weight * assoc.valid
    cost = 0.5 * jnp.sum(w * rho_s)
    wd = w * drho
    g = jnp.einsum("sm,smdp,smd->p", wd, J, r)
    H = jnp.einsum("sm,smdp,smdq->pq", wd, J, J)
    if reg.soft_constraint and soft_sqrt_info is not None:
        # mahalanobis prior on the initial guess, weighted sqrt(N cells)
        # (`n_scan_normal.cpp:373-377`)
        d = pose - guess
        d = d.at[2].set(se2.normalize_angle(d[2]))
        rs = soft_scale * (soft_sqrt_info @ d)
        cost = cost + 0.5 * jnp.sum(rs * rs)
        Js = soft_scale * soft_sqrt_info
        g = g + Js.T @ rs
        H = H + Js.T @ Js
    return cost, g, H


# ---------------------------------------------------------------------------
# inner trust-region LM solve (Ceres-style)
# ---------------------------------------------------------------------------

class _LMState(NamedTuple):
    pose: jax.Array
    cost: jax.Array
    g: jax.Array
    H: jax.Array
    radius: jax.Array
    decrease_factor: jax.Array
    itr: jax.Array
    steps: jax.Array
    last_rel_decrease: jax.Array
    done: jax.Array


def _lm_solve(pose0, src, tgt, assoc, cfg: CFEARConfig, guess,
              soft_scale, soft_sqrt_info):
    reg = cfg.registration

    def cgh(p):
        return _cost_grad_hess(p, src, tgt, assoc, cfg, guess,
                               soft_scale, soft_sqrt_info)

    def ceval(p):
        return _cost_only(p, src, tgt, assoc, cfg, guess,
                          soft_scale, soft_sqrt_info)

    cost0, g0, H0 = cgh(pose0)

    def body(st: _LMState) -> _LMState:
        # carried (cost, g, H) are valid at st.pose: one trial (cost-only)
        # pass + one full pass at the selected pose per iteration
        diag = jnp.clip(jnp.diag(st.H), 1e-6, 1e32)
        Hlm = st.H + jnp.diag(diag) / st.radius
        delta = -_solve3(Hlm, st.g)
        new_pose = st.pose + delta
        new_cost = ceval(new_pose)
        model_red = -(st.g @ delta + 0.5 * delta @ (st.H @ delta))
        rel_decrease = (st.cost - new_cost) / jnp.maximum(model_red, 1e-30)
        accept = (rel_decrease > 1e-3) & jnp.isfinite(new_cost)
        # ceres trust-region radius update
        shrink = 1.0 - (2.0 * rel_decrease - 1.0) ** 3
        radius_ok = st.radius / jnp.maximum(jnp.maximum(shrink, 1.0 / 3.0), 1e-3)
        radius_bad = st.radius / st.decrease_factor
        func_conv = jnp.abs(st.cost - new_cost) <= reg.function_tolerance * st.cost
        # if even the quadratic model predicts < tolerance improvement, the
        # solve has converged regardless of step acceptance
        pred_conv = model_red <= reg.function_tolerance * st.cost
        step_small = jnp.linalg.norm(delta) <= 1e-8 * (jnp.linalg.norm(st.pose) + 1e-8)
        done = (accept & func_conv) | pred_conv | step_small | (radius_bad < 1e-32)
        sel_pose = jnp.where(accept, new_pose, st.pose)
        # only recompute grad/Hessian when the step was accepted (lax.cond
        # executes a single branch when not vmapped)
        cost2, g2, H2 = jax.lax.cond(
            accept, lambda: cgh(new_pose), lambda: (st.cost, st.g, st.H))
        return _LMState(
            pose=sel_pose,
            cost=cost2, g=g2, H=H2,
            radius=jnp.where(accept, jnp.minimum(radius_ok, 1e16), radius_bad),
            decrease_factor=jnp.where(accept, 2.0, st.decrease_factor * 2.0),
            itr=st.itr + 1,
            steps=st.steps + accept.astype(jnp.int32),
            last_rel_decrease=rel_decrease,
            done=done,
        )

    def cond(st: _LMState):
        return (~st.done) & (st.itr < reg.max_itr_solver)

    init = _LMState(pose=pose0, cost=cost0, g=g0, H=H0,
                    radius=jnp.asarray(1e4, pose0.dtype),
                    decrease_factor=jnp.asarray(2.0, pose0.dtype),
                    itr=jnp.asarray(0, jnp.int32), steps=jnp.asarray(0, jnp.int32),
                    last_rel_decrease=jnp.asarray(jnp.inf, pose0.dtype),
                    done=jnp.asarray(False))
    final = jax.lax.while_loop(cond, body, init)
    return final


# ---------------------------------------------------------------------------
# packed LM solve (the hot path without the soft constraint)
# ---------------------------------------------------------------------------
#
# Association data packed as (8, N) f32 rows, N = S*M:
#   P2P / P2D: [sx, sy, mx, my, w, l11, l21, l22]   (l* = sqrt-info; 1/0 for P2P)
#   P2L:       [sx, sy, mx, my, w, nx, ny, pad]
# Every residual quantity is one elementwise op over N, and the cost,
# gradient and 6 Hessian entries are plain reductions. The robust loss
# rho/rho' is inlined per the static config (losses.rho).

def pack_associations(src_mean, tgt, assoc_weight, cfg: CFEARConfig):
    """(S, M) association data -> (8, S*M) packed f32 block.

    Invalid associations carry weight 0 and contribute nothing.
    """
    reg = cfg.registration
    s, m = assoc_weight.shape
    n = s * m

    def flat(x):
        return x.reshape(n)

    sx = flat(jnp.broadcast_to(src_mean[None, :, 0], (s, m)))
    sy = flat(jnp.broadcast_to(src_mean[None, :, 1], (s, m)))
    mx = flat(tgt["mean"][..., 0])
    my = flat(tgt["mean"][..., 1])
    w = flat(assoc_weight)
    if reg.cost == "P2L":
        r5 = flat(tgt["normal"][..., 0])
        r6 = flat(tgt["normal"][..., 1])
        r7 = jnp.zeros_like(w)
    elif reg.cost == "P2D":
        r5 = flat(tgt["sqrt_info"][..., 0])
        r6 = flat(tgt["sqrt_info"][..., 1])
        r7 = flat(tgt["sqrt_info"][..., 2])
    else:  # P2P: identity sqrt-info
        r5 = jnp.ones_like(w)
        r6 = jnp.zeros_like(w)
        r7 = jnp.ones_like(w)
    return jnp.stack([sx, sy, mx, my, w, r5, r6, r7])


def _lm_funcs(rows, cfg: CFEARConfig):
    """Build the trust-region LM iteration (cgh, body, cond) over packed
    rows (pure jnp closures)."""
    reg = cfg.registration
    cost_metric = reg.cost
    sx, sy, mx, my, w, r5, r6, r7 = rows

    def cgh(px, py, pt):
        """cost, g(3,), H(6 upper entries) at pose (px, py, pt)."""
        c, s = jnp.cos(pt), jnp.sin(pt)
        tx = c * sx - s * sy + px       # transformed source
        ty = s * sx + c * sy + py
        jx = -s * sx - c * sy           # d(tx)/dtheta
        jy = c * sx - s * sy            # d(ty)/dtheta
        dx = tx - mx
        dy = ty - my
        # separate reductions rather than one stacked (10, N) buffer: XLA
        # fuses each into the elementwise producer
        if cost_metric == "P2L":
            e = dx * r5 + dy * r6
            ssq = e * e
            rho, drho = losses.rho(ssq, reg.loss, reg.loss_limit)
            wd = w * drho
            # J = [nx, ny, nx*jx + ny*jy]
            jt = r5 * jx + r6 * jy
            cost = 0.5 * jnp.sum(w * rho)
            g = (jnp.sum(wd * r5 * e), jnp.sum(wd * r6 * e),
                 jnp.sum(wd * jt * e))
            h = (jnp.sum(wd * r5 * r5), jnp.sum(wd * r5 * r6),
                 jnp.sum(wd * r5 * jt), jnp.sum(wd * r6 * r6),
                 jnp.sum(wd * r6 * jt), jnp.sum(wd * jt * jt))
        else:
            # residual = L @ [dx, dy]; L = [[l11, 0], [l21, l22]]
            e0 = r5 * dx
            e1 = r6 * dx + r7 * dy
            ssq = e0 * e0 + e1 * e1
            rho, drho = losses.rho(ssq, reg.loss, reg.loss_limit)
            wd = w * drho
            # J0 = [l11, 0, l11*jx]; J1 = [l21, l22, l21*jx + l22*jy]
            j0t = r5 * jx
            j1t = r6 * jx + r7 * jy
            cost = 0.5 * jnp.sum(w * rho)
            g = (jnp.sum(wd * (r5 * e0 + r6 * e1)), jnp.sum(wd * (r7 * e1)),
                 jnp.sum(wd * (j0t * e0 + j1t * e1)))
            h = (jnp.sum(wd * (r5 * r5 + r6 * r6)), jnp.sum(wd * (r6 * r7)),
                 jnp.sum(wd * (r5 * j0t + r6 * j1t)),
                 jnp.sum(wd * (r7 * r7)), jnp.sum(wd * (r7 * j1t)),
                 jnp.sum(wd * (j0t * j0t + j1t * j1t)))
        return cost, g, h

    def cost_only(px, py, pt):
        c, s = jnp.cos(pt), jnp.sin(pt)
        tx = c * sx - s * sy + px
        ty = s * sx + c * sy + py
        dx = tx - mx
        dy = ty - my
        if cost_metric == "P2L":
            e = dx * r5 + dy * r6
            ssq = e * e
        else:
            e0 = r5 * dx
            e1 = r6 * dx + r7 * dy
            ssq = e0 * e0 + e1 * e1
        rho, _ = losses.rho(ssq, reg.loss, reg.loss_limit)
        return 0.5 * jnp.sum(w * rho)

    def solve3(h, g):
        hxx, hxy, hxt, hyy, hyt, htt = h
        c00 = hyy * htt - hyt * hyt
        c01 = hxt * hyt - hxy * htt
        c02 = hxy * hyt - hxt * hyy
        c11 = hxx * htt - hxt * hxt
        c12 = hxy * hxt - hxx * hyt
        c22 = hxx * hyy - hxy * hxy
        det = hxx * c00 + hxy * c01 + hxt * c02
        inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
        dx = (c00 * g[0] + c01 * g[1] + c02 * g[2]) * inv_det
        dy = (c01 * g[0] + c11 * g[1] + c12 * g[2]) * inv_det
        dt = (c02 * g[0] + c12 * g[1] + c22 * g[2]) * inv_det
        return dx, dy, dt

    def body(carry):
        (px, py, pt, cost, g, h, radius, dec, itr, steps, lastrel, done) = carry
        hxx, hxy, hxt, hyy, hyt, htt = h
        dxx = jnp.clip(hxx, 1e-6, 1e32) / radius
        dyy = jnp.clip(hyy, 1e-6, 1e32) / radius
        dtt = jnp.clip(htt, 1e-6, 1e32) / radius
        hlm = (hxx + dxx, hxy, hxt, hyy + dyy, hyt, htt + dtt)
        sx_, sy_, st_ = solve3(hlm, (-g[0], -g[1], -g[2]))
        npx, npy, npt = px + sx_, py + sy_, pt + st_
        new_cost = cost_only(npx, npy, npt)
        gd = g[0] * sx_ + g[1] * sy_ + g[2] * st_
        hd0 = hxx * sx_ + hxy * sy_ + hxt * st_
        hd1 = hxy * sx_ + hyy * sy_ + hyt * st_
        hd2 = hxt * sx_ + hyt * sy_ + htt * st_
        model_red = -(gd + 0.5 * (sx_ * hd0 + sy_ * hd1 + st_ * hd2))
        rel = (cost - new_cost) / jnp.maximum(model_red, 1e-30)
        accept = (rel > 1e-3) & jnp.isfinite(new_cost)
        shrink = 1.0 - (2.0 * rel - 1.0) ** 3
        r_ok = radius / jnp.maximum(jnp.maximum(shrink, 1.0 / 3.0), 1e-3)
        r_bad = radius / dec
        func_conv = jnp.abs(cost - new_cost) <= reg.function_tolerance * cost
        pred_conv = model_red <= reg.function_tolerance * cost
        stepn = jnp.sqrt(sx_ * sx_ + sy_ * sy_ + st_ * st_)
        posen = jnp.sqrt(px * px + py * py + pt * pt)
        step_small = stepn <= 1e-8 * (posen + 1e-8)
        new_done = (accept & func_conv) | pred_conv | step_small | (r_bad < 1e-32)
        spx = jnp.where(accept, npx, px)
        spy = jnp.where(accept, npy, py)
        spt = jnp.where(accept, npt, pt)
        cost2, g2, h2 = cgh(spx, spy, spt)
        cost2 = jnp.where(accept, cost2, cost)
        g2 = tuple(jnp.where(accept, a, b) for a, b in zip(g2, g))
        h2 = tuple(jnp.where(accept, a, b) for a, b in zip(h2, h))
        return (spx, spy, spt, cost2, g2, h2,
                jnp.where(accept, jnp.minimum(r_ok, 1e16), r_bad),
                jnp.where(accept, 2.0, dec * 2.0),
                itr + 1, steps + accept.astype(jnp.int32), rel, new_done)

    def cond(carry):
        itr, done = carry[8], carry[11]
        return jnp.logical_not(done) & (itr < reg.max_itr_solver)

    return cgh, body, cond


def _lm_core(rows, px0, py0, pt0, cfg: CFEARConfig):
    """The trust-region LM loop over packed rows.
    Returns (px, py, pt, cost, steps_f32, last_rel)."""
    reg = cfg.registration
    cgh, body, cond = _lm_funcs(rows, cfg)
    cost0, g0, h0 = cgh(px0, py0, pt0)
    init = (px0, py0, pt0, cost0, g0, h0,
            jnp.float32(1e4), jnp.float32(2.0),
            jnp.int32(0), jnp.int32(0), jnp.float32(jnp.inf),
            jnp.asarray(False))
    if reg.unroll_solver:
        # straight-line masked iterations: identical results to the while
        # loop (converged state is frozen), but no per-iteration loop sync
        # and no cross-lane lockstep under vmap
        carry = init
        for _ in range(reg.max_itr_solver):
            new = body(carry)
            done = carry[11]
            carry = jax.tree.map(
                lambda c, n: jnp.where(done, c, n), carry, new)
        (px, py, pt, cost, g, h, radius, dec, itr, steps, lastrel, done) = carry
    else:
        (px, py, pt, cost, g, h, radius, dec, itr, steps, lastrel, done) = \
            jax.lax.while_loop(cond, body, init)
    return px, py, pt, cost, steps.astype(jnp.float32), lastrel


def lm_solve_packed_xla(packed, pose0, cfg: CFEARConfig):
    """The packed LM solve from `pose0`: (pose, cost, steps, last_rel).
    Far fewer operations per iteration than the einsum formulation of
    `_lm_solve`."""
    rows = tuple(packed[i] for i in range(8))
    p = pose0.astype(jnp.float32)
    px, py, pt, cost, steps_f, lastrel = _lm_core(rows, p[0], p[1], p[2], cfg)
    pose = jnp.stack([px, py, pt]).astype(pose0.dtype)
    return pose, cost, steps_f.astype(jnp.int32), lastrel


# ---------------------------------------------------------------------------
# full registration (outer association loop)
# ---------------------------------------------------------------------------

_FAST_DENSE = ("dense", "sparse")


# the block-sparse kernel pays when a call has this many (lane, keyframe)
# windows or more; see `resolve_assoc_method`
SPARSE_MIN_WINDOWS = 32


def resolve_assoc_method(cfg: CFEARConfig, s_act: int, lanes: int = 1) -> str:
    """Resolve `assoc_method="auto"` to a concrete backend for a window of
    `s_act` active keyframes, run for `lanes` vmapped lanes at once.

    ONE shared policy for `register()`, `get_cost()`, `sample_covariance()`
    and `cost_surface()` — the reference evaluates GetCost on the same
    problem structure as Register (`n_scan_normal.cpp:188-213`), so the
    cost-sampling covariance must ride the same fast backends. Keyed on
    `runtime.platform()`: dense XLA on the CPU (the kernel has no CPU
    compiler); on the GPU the block-sparse kernel when cells are
    Morton-ordered and s_act * lanes >= SPARSE_MIN_WINDOWS, else dense XLA.
    Measured end to end on an H100 (700 W, batched step, two sets of
    sequences), kernel against dense frames/s: 4 keyframes -4.4 % / -0.1 %
    at 1 lane, +3.4 % / +2.2 % at 8; 8 keyframes -5.3 % / -0.2 % at 1 lane,
    +6.4 % / +9.8 % at 8; 16 keyframes -7.5 % / -1.7 % at 1 lane, +14.7 % /
    +13.1 % at 8; 50 keyframes (400 W) +10 % at 1 lane, +36 % at 8. All
    backends produce identical accepted associations.
    """
    method = cfg.registration.assoc_method
    if method != "auto":
        return method
    if (runtime.platform() == "gpu" and cfg.feature.spatial_sort
            and s_act * lanes >= SPARSE_MIN_WINDOWS):
        return "sparse"
    return "dense"


def for_lanes(cfg: CFEARConfig, lanes: int) -> CFEARConfig:
    """`cfg` with `assoc_method="auto"` resolved for a step that vmaps
    `lanes` sequences: `register()` cannot see the batch it runs in."""
    reg = cfg.registration
    if reg.assoc_method != "auto":
        return cfg
    s_all = cfg.odometry.submap_scan_size
    s_act = min(reg.max_active_keyframes or s_all, s_all)
    return cfg.replace(registration=dataclasses.replace(
        reg, assoc_method=resolve_assoc_method(cfg, s_act, lanes)))


def _active_window(kf_cells: CellMap, kf_poses, kf_valid, center, cfg):
    """Keyframe-axis distance gate (`max_active_keyframes`): shrink the
    (S, M, ...) window to the K keyframes nearest `center`.

    Exact when every keyframe overlapping the scan is among the K nearest
    (distant keyframes share no cells within the association gate). Shared
    by `register()` and the cost-evaluation entry points so covariance
    sampling sees the same active window the solve used."""
    reg = cfg.registration
    s_all = kf_cells.valid.shape[0]
    if not reg.max_active_keyframes or reg.max_active_keyframes >= s_all:
        return kf_cells, kf_poses, kf_valid
    d2_kf = jnp.sum((kf_poses[:, :2] - center[:2]) ** 2, -1)
    d2_kf = jnp.where(kf_valid, d2_kf, jnp.inf)
    _, sel = jax.lax.top_k(-d2_kf, reg.max_active_keyframes)
    kf_cells = jax.tree.map(lambda a: jnp.take(a, sel, axis=0), kf_cells)
    return (kf_cells, jnp.take(kf_poses, sel, axis=0),
            jnp.take(kf_valid, sel, axis=0))


class _OuterState(NamedTuple):
    pose: jax.Array
    prev_pose: jax.Array
    prev_score: jax.Array
    final_cost: jax.Array
    num_assoc: jax.Array
    num_res_scalars: jax.Array
    itr: jax.Array
    done: jax.Array
    failed: jax.Array
    assoc: Associations     # associations of the last executed iteration


def register(kf_cells: CellMap, kf_poses, kf_valid, src: CellMap, guess,
             reg_cov_guess=None, cfg: CFEARConfig = None) -> RegistrationResult:
    """Register the newest scan against S keyframes; refine only its pose.

    Arguments mirror `Register(scans, Tsrc, reg_cov, soft)`
    (`n_scan_normal.cpp:82-187`): `kf_cells` is the keyframe window batched
    on axis 0 (S, M, ...), `kf_poses` (S, 3) are FIXED world poses, `src` is
    the newest scan in its local frame and `guess` (3,) its initial pose.
    """
    reg = cfg.registration
    dtype = guess.dtype
    res_dim = 1 if reg.cost == "P2L" else 2

    # keyframe-axis distance gate (`max_active_keyframes`) at the guess
    # pose, ONCE per call — keyframe origins are fixed during the solve and
    # the pose moves by less than the association radius, so the nearest
    # set is stable.
    kf_cells, kf_poses, kf_valid = _active_window(
        kf_cells, kf_poses, kf_valid, guess, cfg)

    if reg.soft_constraint:
        if reg_cov_guess is None:
            reg_cov_guess = jnp.eye(3, dtype=dtype)
        soft_scale = jnp.sqrt(jnp.maximum(jnp.sum(src.valid), 1.0)).astype(dtype)
        # sqrt information of the guess prior: chol of cov^{-1}
        soft_sqrt_info = jnp.linalg.cholesky(
            _inv3(reg_cov_guess + 1e-9 * jnp.eye(3, dtype=dtype)))
    else:
        soft_scale = jnp.asarray(0.0, dtype)
        soft_sqrt_info = None

    method = resolve_assoc_method(cfg, kf_cells.valid.shape[0])
    fast_dense = method in _FAST_DENSE
    if method == "grid":
        buckets = jax.vmap(lambda c: build_buckets(c, cfg))(kf_cells)
    else:
        buckets = None
    attrs = _world_attrs(kf_cells, kf_poses, cfg) if fast_dense else None
    cos_gate = math.cos(math.radians(reg.angle_outlier_deg))

    def outer_body(st: _OuterState) -> _OuterState:
        itr1 = st.itr + 1
        # coarse-to-fine association radius (`n_scan_normal.cpp:222`)
        radius = jnp.where(itr1 == 1, 2.0 * reg.assoc_radius, reg.assoc_radius)
        if fast_dense:
            assoc, tgt = _associate_world(attrs, src, st.pose, kf_valid,
                                          radius, cfg, cos_gate, method)
        else:
            assoc = associate(kf_cells, kf_poses, kf_valid, src, st.pose,
                              radius, cfg, buckets)
            tgt = _target_terms(kf_cells, kf_poses, assoc, cfg)
        n_assoc = jnp.sum(assoc.valid)
        n_res = n_assoc * res_dim + (3 if reg.soft_constraint else 0)
        failed = n_res <= 1                     # (`n_scan_normal.cpp:370`)
        if not reg.soft_constraint:
            packed = pack_associations(
                src.mean, tgt, assoc.weight * assoc.valid, cfg)
            lm_pose, lm_cost, lm_steps, lm_rel = \
                lm_solve_packed_xla(packed, st.pose, cfg)
            lm = _LMState(pose=lm_pose, cost=lm_cost, g=None, H=None,
                          radius=None, decrease_factor=None, itr=None,
                          steps=lm_steps, last_rel_decrease=lm_rel,
                          done=None)
        else:
            lm = _lm_solve(st.pose, src, tgt, assoc, cfg, guess,
                           soft_scale, soft_sqrt_info)
        current_score = lm.cost
        rel_improvement = (st.prev_score - current_score) / st.prev_score
        # convergence rules (`n_scan_normal.cpp:134-149`), active after min_itr
        check = itr1 > reg.min_itr
        worse = check & (st.prev_score < current_score)
        conv = check & ((rel_improvement < reg.score_tolerance)
                        | (lm.last_rel_decrease < reg.score_tolerance)
                        | (lm.steps == 0))
        pose_out = jnp.where(worse, st.prev_pose, lm.pose)
        return _OuterState(
            pose=pose_out,
            prev_pose=jnp.where(worse | conv, st.prev_pose, lm.pose),
            prev_score=jnp.where(worse | conv, st.prev_score, current_score),
            final_cost=jnp.where(worse, st.final_cost, current_score),
            num_assoc=n_assoc.astype(jnp.int32),
            num_res_scalars=n_res.astype(jnp.int32),
            itr=itr1,
            done=worse | conv | failed,
            failed=failed,
            assoc=assoc,
        )

    def outer_cond(st: _OuterState):
        return (~st.done) & (st.itr < reg.max_itr_association)

    s_kf, m_src = kf_cells.valid.shape[0], src.valid.shape[0]
    init = _OuterState(pose=guess, prev_pose=guess,
                       prev_score=jnp.asarray(jnp.finfo(dtype).max, dtype),
                       final_cost=jnp.asarray(jnp.finfo(dtype).max, dtype),
                       num_assoc=jnp.asarray(0, jnp.int32),
                       num_res_scalars=jnp.asarray(0, jnp.int32),
                       itr=jnp.asarray(0, jnp.int32),
                       done=jnp.asarray(False), failed=jnp.asarray(False),
                       assoc=Associations(
                           tar_idx=jnp.zeros((s_kf, m_src), jnp.int32),
                           weight=jnp.zeros((s_kf, m_src), dtype),
                           valid=jnp.zeros((s_kf, m_src), bool)))
    if reg.disable_registration:
        eye = jnp.eye(3, dtype=dtype)
        return RegistrationResult(guess, eye, jnp.asarray(True),
                                  jnp.asarray(0.0, dtype), jnp.asarray(0.0, dtype),
                                  jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))

    if reg.unroll_solver:
        # straight-line masked outer iterations (same semantics as the
        # while loop: state freezes once done)
        final = init
        for _ in range(reg.max_itr_association):
            new = outer_body(final)
            final = jax.tree.map(
                lambda c, n, d=final.done: jnp.where(d, c, n), final, new)
    else:
        final = jax.lax.while_loop(outer_cond, outer_body, init)

    # --- covariance: Censi-style scaled inverse GN Hessian ---------------
    # (`n_scan_normal.cpp:392-433`): cov = 30 * final_cost/(n_res - n_par) * H^-1,
    # evaluated at the final pose on the LAST BUILT problem's associations
    # (Ceres keeps the problem from the final association iteration; no
    # fresh association happens for the covariance)
    assoc = final.assoc
    if fast_dense:
        tgt = _tgt_from_attrs(
            jax.vmap(lambda a, i: a[i])(attrs, assoc.tar_idx), cfg)
    else:
        tgt = _target_terms(kf_cells, kf_poses, assoc, cfg)
    cost_f, _, H = _cost_grad_hess(final.pose, src, tgt, assoc, cfg, guess,
                                   soft_scale, soft_sqrt_info)
    dof = jnp.maximum(final.num_res_scalars.astype(dtype) - 3.0, 1.0)
    Hinv = _inv3(H + 1e-9 * jnp.eye(3, dtype=dtype))
    cov = reg.covariance_scaler * (cost_f / dof) * Hinv
    score = final.final_cost / jnp.maximum(
        final.num_res_scalars.astype(dtype), 1.0)
    # divergence-as-failure (`min_assoc_fraction` / `max_score` in config):
    # a solve whose associations collapsed, or whose per-residual score
    # blew past the ceiling, is reported as FAILED even though the LM loop
    # "converged" — the caller falls back to the motion guess and counts it
    # (matching `odometrykeyframefuser.cpp:190-199` failure semantics)
    possible = jnp.maximum(
        jnp.sum(src.valid) * jnp.sum(kf_valid), 1).astype(dtype)
    frac = final.num_assoc.astype(dtype) / possible
    collapsed = frac < reg.min_assoc_fraction
    if math.isfinite(reg.max_score):
        collapsed = collapsed | (score > reg.max_score)
    return RegistrationResult(
        pose=final.pose, cov=cov, success=~final.failed & ~collapsed,
        score=score, final_cost=final.final_cost, num_assoc=final.num_assoc,
        iterations=final.itr)


def is_consistent(pose, guess, max_distance: float = 1.0,
                  max_angle_deg: float = 5.0):
    """Consistency gate of a registration result against its initial guess.

    Equivalent of the service node's `IsConsistent`
    (`registration_srv_node.cpp:131-142`): reject when the discrepancy
    T_guess^{-1} T_pose exceeds the translation / rotation limits.
    """
    d = se2.relative(guess, pose)
    dist = jnp.linalg.norm(d[:2])
    ang = jnp.abs(jnp.degrees(se2.normalize_angle(d[2])))
    return (dist <= max_distance) & (ang <= max_angle_deg)


def register_scans_service(scans: CellMap, poses, cfg: CFEARConfig,
                           consistency_max_distance: float = 1.0,
                           consistency_max_angle_deg: float = 5.0):
    """"Registration as a service": register the newest of N scans against
    the rest and gate the result on consistency with the initial guess
    (the disabled `registration_srv_node` capability,
    `registration_srv_node.cpp:242-313`). Returns (result, consistent)."""
    s = poses.shape[0]
    kf = jax.tree.map(lambda a: a[:-1], scans)
    src = jax.tree.map(lambda a: a[-1], scans)
    res = register(kf, poses[:-1], jnp.ones((s - 1,), bool), src, poses[-1],
                   cfg=cfg)
    ok = res.success & is_consistent(res.pose, poses[-1],
                                     consistency_max_distance,
                                     consistency_max_angle_deg)
    return res, ok


def refine_many_to_many(cells: CellMap, poses, valid, cfg: CFEARConfig,
                        fixed_mask=None, outer_iters: int = 4,
                        gn_iters: int = 8, cg_iters: int = 24,
                        pairs_per_scan: int | None = None):
    """Joint refinement of ALL scan poses ("many_to_many_refinement",
    `registration.h:48`, pair enumeration `n_scan_normal.cpp:359-367`).

    Scan pairs (target i, source j) contribute associations; residuals
    depend on BOTH poses (the non-"efficient" cost functors,
    `n_scan_normal.h:134-176`). The normal equations over the 3*S pose block
    are solved matrix-free (vjp/jvp + CG) with the first pose gauge-fixed
    (or `fixed_mask`). Returns refined (S, 3) poses.

    Scaling design (s50-capable): instead of the S^2 ordered-pair
    enumeration, each source scan is paired with its `pairs_per_scan`
    nearest valid targets by initial pose-origin distance (default
    min(S-1, 8); scans further apart than the association radius + scan
    extent share no associations anyway, so for small S with overlapping
    scans this is exhaustive). All loops (outer re-association, GN, CG) are
    `lax.fori_loop`s and the pair dimension is vmapped, so the whole
    refinement is ONE compiled program whose trace size is independent of
    the iteration counts — S=50 compiles in seconds, not the minutes the
    Python-unrolled S^2 formulation took at S=3.
    """
    reg = cfg.registration
    s = poses.shape[0]
    if fixed_mask is None:
        fixed_mask = jnp.zeros((s,), bool).at[0].set(True)
    free = ~fixed_mask
    k = pairs_per_scan if pairs_per_scan else min(s - 1, 8)

    # static pair selection from the INITIAL poses: refinement moves poses
    # by centimetres while the pairing granularity is whole metres, so the
    # nearest-target sets never change across outer iterations
    d0 = jnp.linalg.norm(poses[None, :, :2] - poses[:, None, :2], axis=-1)
    d0 = jnp.where(valid[:, None] & valid[None, :], d0, jnp.inf)
    d0 = jnp.where(jnp.eye(s, dtype=bool), jnp.inf, d0)       # i != j
    order = jnp.argsort(d0, axis=0)                           # per source j
    ii = order[:k, :].T.reshape(-1)                           # (S*k,) targets
    jj = jnp.repeat(jnp.arange(s), k)                         # (S*k,) sources
    pair_ok = jnp.isfinite(
        d0[ii, jj]) & valid[ii] & valid[jj]                   # (S*k,)
    cos_gate = math.cos(math.radians(reg.angle_outlier_deg))

    def pair_assoc(cur, i, j, ok_pair):
        """Exact dense 1-NN of source j's cells into target i's frame."""
        t_rel = se2.relative(cur[i], cur[j])
        src_mean_t = se2.transform(t_rel, cells.mean[j])      # (M, 2)
        src_norm_t = se2.rotate(t_rel, cells.normal[j])
        nn, nn_d2 = nn_dense(src_mean_t, cells.mean[i][None],
                             cells.valid[i][None])
        nn, nn_d2 = nn[0], nn_d2[0]
        sim_dir = jnp.maximum(
            jnp.sum(src_norm_t * cells.normal[i][nn], -1), 0.0)
        ok = (cells.valid[j] & ok_pair
              & (nn_d2 < reg.assoc_radius ** 2) & (sim_dir > cos_gate))
        w = losses.association_weight(
            reg.weight_opt, cells.nsamples[j], cells.nsamples[i][nn],
            sim_dir, cells.planarity[j], cells.planarity[i][nn])
        return nn.astype(jnp.int32), jnp.where(ok, w, 0.0)

    def residuals(p, tar_idx, w_a):
        def one_pair(i, j, tar_i, w_i):
            src_w = se2.transform(p[j], cells.mean[j])         # (M, 2)
            tar_w = se2.transform(p[i], cells.mean[i][tar_i])
            d = src_w - tar_w
            if reg.cost == "P2L":
                n_w = se2.rotate(p[i], cells.normal[i][tar_i])
                e = jnp.sum(d * n_w, -1, keepdims=True)
            else:
                e = d
            ssq = jnp.sum(e * e, -1)
            _, drho = losses.rho(ssq, reg.loss, reg.loss_limit)
            # IRLS: the robust weight is constant within a GN step
            # (sqrt has an infinite derivative at 0 otherwise)
            wr = jax.lax.stop_gradient(jnp.sqrt(w_i * drho))
            return e * wr[:, None]

        return jax.vmap(one_pair)(ii, jj, tar_idx, w_a)

    def proj(x):
        return jnp.where(free[:, None], x, 0.0)

    def outer_body(_, cur):
        tar_idx, w_a = jax.vmap(
            lambda i, j, ok: pair_assoc(cur, i, j, ok))(ii, jj, pair_ok)

        def gn_body(_, p):
            r, vjp = jax.vjp(lambda q: residuals(q, tar_idx, w_a), p)
            (grad,) = vjp(r)
            grad = proj(grad)

            def hvp(x):
                x = proj(x)
                _, jv = jax.jvp(
                    lambda q: residuals(q, tar_idx, w_a), (p,), (x,))
                (h,) = vjp(jv)
                return proj(h) + 1e-6 * x

            def cg_body(_, st):
                x, rr, pp, rs = st
                Ap = hvp(pp)
                denom = jnp.sum(pp * Ap)
                alpha = rs / jnp.where(denom > 0, denom, 1.0)
                x = x + alpha * pp
                rr = rr - alpha * Ap
                rs_new = jnp.sum(rr * rr)
                pp2 = rr + (rs_new / jnp.where(rs > 0, rs, 1.0)) * pp
                return x, rr, pp2, rs_new

            b = -grad
            x, *_ = jax.lax.fori_loop(
                0, cg_iters, cg_body, (jnp.zeros_like(b), b, b,
                                       jnp.sum(b * b)))
            return p + proj(x)

        return jax.lax.fori_loop(0, gn_iters, gn_body, cur)

    refine = jax.jit(lambda p0: jax.lax.fori_loop(0, outer_iters,
                                                  outer_body, p0))
    return refine(poses)


def register_time_continuous(kf_cells: CellMap, kf_poses, kf_valid,
                             src: CellMap, guess, tvel, ccw: bool,
                             cfg: CFEARConfig = None) -> RegistrationResult:
    """Time-continuous variant (`RegisterTimeContinuous`,
    `n_scan_normal.cpp:67-80`): each source cell is pre-warped by the scaled
    velocity at its relative scan time before the ordinary solve. The
    reference folds the (FIXED, non-optimized) velocity warp into the cost
    functor (`P2PEfficientContinuousCost`, `n_scan_normal.h:363-404`) and
    into association (`:233-237`); pre-compensating the cells is equivalent.
    Flag-gated and off by default, like the reference ("doesn't improve
    results", `n_scan_normal.cpp:227`).
    """
    from cfear_jax.ops.features import (
        compensate_cells)
    src_warped = compensate_cells(src, tvel, ccw)
    return register(kf_cells, kf_poses, kf_valid, src_warped, guess, cfg=cfg)


def sample_covariance(kf_cells: CellMap, kf_poses, kf_valid, src: CellMap,
                      pose, cfg: CFEARConfig):
    """Covariance by cost sampling around the registration optimum.

    Reproduces `approximateCovarianceBySampling`
    (`odometrykeyframefuser.cpp:261-380`): evaluate the association cost on a
    k^3 grid of (x, y, yaw) offsets (k = cov_sampling_samples_per_axis), fit
    a 10-coefficient quadratic by least squares, build its constant Hessian,
    and — if convex — return cov = 2 H^{-1} * score_scale * scaler with
    score_scale = final_cost / (n_res - n_par) (`GetCovarianceScaler`,
    `n_scan_normal.cpp:435-441`). Returns (cov3, ok).
    """
    odo = cfg.odometry
    k = odo.cov_sampling_samples_per_axis
    dtype = pose.dtype
    xy = jnp.linspace(-odo.cov_sampling_xy_range * 0.5,
                      odo.cov_sampling_xy_range * 0.5, k).astype(dtype)
    th = jnp.linspace(-odo.cov_sampling_yaw_range * 0.5,
                      odo.cov_sampling_yaw_range * 0.5, k).astype(dtype)
    gx, gy, gt_ = jnp.meshgrid(xy, xy, th, indexing="ij")
    offs = jnp.stack([gx.ravel(), gy.ravel(), gt_.ravel()], -1)  # (k^3, 3)

    # gate the window + pre-pack the world attributes ONCE at the center
    # pose: the offsets are centimetre-scale, so the active-keyframe set
    # and the (fixed) keyframe transforms are shared by all k^3 samples
    kf_cells, kf_poses, kf_valid = _active_window(
        kf_cells, kf_poses, kf_valid, pose, cfg)
    method = resolve_assoc_method(cfg, kf_cells.valid.shape[0])
    attrs = (_world_attrs(kf_cells, kf_poses, cfg)
             if method in _FAST_DENSE else None)

    def cost_at(off):
        c, n = get_cost(kf_cells, kf_poses, kf_valid, src, pose + off, cfg,
                        attrs=attrs)
        return c, n

    costs, n_res = jax.vmap(cost_at)(offs)
    x, y, t = offs[:, 0], offs[:, 1], offs[:, 2]
    A = jnp.stack([x * x, y * y, t * t, x * y, y * t, t * x, x, y, t,
                   jnp.ones_like(x)], -1)
    coef, *_ = jnp.linalg.lstsq(A, costs)
    H = jnp.array([[2 * coef[0], coef[3], coef[5]],
                   [coef[3], 2 * coef[1], coef[4]],
                   [coef[5], coef[4], 2 * coef[2]]])
    evals = jnp.linalg.eigvalsh(H)
    convex = jnp.all(evals > 0.0)
    # score scale from the center sample
    center = jnp.argmin(jnp.sum(offs * offs, -1))
    dof = jnp.maximum(n_res[center].astype(dtype) - 3.0, 1.0)
    score_scale = costs[center] / dof
    cov = 2.0 * jnp.linalg.inv(H + (1.0 - convex) * jnp.eye(3, dtype=dtype)) \
        * score_scale * odo.cov_sampling_covariance_scaler
    return cov, convex


def cost_surface(kf_cells: CellMap, kf_poses, kf_valid, src: CellMap, pose,
                 cfg: CFEARConfig, width: float = 5.0, res: float = 0.25):
    """Sample the registration cost on an (x, y) grid around `pose`.

    Equivalent of `GetSurface` (`n_scan_normal.cpp:29-65`), used to inspect
    the objective landscape. Returns (surface (P, P), extent tuple) with
    P = 2*ceil(width/res)+1 pixels.
    """
    import math as _math
    p = 2 * int(_math.ceil(width / res)) + 1
    offs = jnp.linspace(-width, width, p).astype(pose.dtype)
    gx, gy = jnp.meshgrid(offs, offs, indexing="xy")
    grid = jnp.stack([gx.ravel(), gy.ravel(),
                      jnp.zeros_like(gx.ravel())], -1)

    method = resolve_assoc_method(cfg, kf_cells.valid.shape[0])
    attrs = (_world_attrs(kf_cells, kf_poses, cfg)
             if method in _FAST_DENSE else None)

    def at(off):
        c, _ = get_cost(kf_cells, kf_poses, kf_valid, src, pose + off, cfg,
                        attrs=attrs)
        return c

    surface = jax.vmap(at)(grid).reshape(p, p)
    return surface, (-width, width, -width, width)


def get_cost(kf_cells: CellMap, kf_poses, kf_valid, src: CellMap, src_pose,
             cfg: CFEARConfig, attrs=None) -> Tuple[jax.Array, jax.Array]:
    """Evaluate the association cost at a fixed pose (no solve).

    Equivalent of `GetCost` (`n_scan_normal.cpp:188-213`); used for the
    covariance-by-cost-sampling path (`odometrykeyframefuser.cpp:261-380`).
    Rides the SAME association backends as `register()` (shared
    `resolve_assoc_method`), so cost sampling at s50 scale uses the same
    pre-packed world attributes rather than S per-keyframe passes. Callers
    evaluating many poses against a fixed window should pass pre-packed
    `attrs` from `_world_attrs` to amortize the keyframe transform.
    Returns (total_cost, num_residual_scalars).
    """
    reg = cfg.registration
    method = resolve_assoc_method(cfg, kf_cells.valid.shape[0])
    cos_gate = math.cos(math.radians(reg.angle_outlier_deg))
    if method in _FAST_DENSE:
        if attrs is None:
            attrs = _world_attrs(kf_cells, kf_poses, cfg)
        assoc, tgt = _associate_world(attrs, src, src_pose, kf_valid,
                                      reg.assoc_radius, cfg, cos_gate,
                                      method)
    else:
        assoc = associate(kf_cells, kf_poses, kf_valid, src, src_pose,
                          reg.assoc_radius, cfg)
        tgt = _target_terms(kf_cells, kf_poses, assoc, cfg)
    dummy_info = jnp.eye(3, dtype=src_pose.dtype)
    cost, _, _ = _cost_grad_hess(src_pose, src, tgt, assoc, cfg, src_pose,
                                 jnp.asarray(0.0, src_pose.dtype), dummy_info)
    res_dim = 1 if reg.cost == "P2L" else 2
    return cost, jnp.sum(assoc.valid) * res_dim
