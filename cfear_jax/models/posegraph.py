"""Pose-graph back-end: odometry + loop-closure constraints, GN optimization.

Data-model rebuild of the reference's `simple_graph`
(`types.h:93-196`: RadarScan poses + Constraint3d {id_begin, id_end, t_be,
6x6 information, type}) with an accelerator-resident optimizer: instead of a sparse
direct solver, Gauss-Newton steps are computed matrix-free — the GN
normal-equation matvec H x = J^T J x is evaluated edge-wise via jvp/vjp of
the residual function and reduced with `psum` when edges are sharded across
devices (`parallel/pgo.py`), and the linear system is solved with conjugate
gradients. Poses are gauge-fixed at node 0.

Residual per constraint (standard SE(2) pose-graph error, matching the
semantics of Ceres' 2-D pose-graph formulation used downstream of the
reference): r = sqrt_info @ [R_i^T (t_j - t_i) - t_ij ; wrap(th_j - th_i - th_ij)].
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from cfear_jax.ops import losses
from cfear_jax.utils import se2

# constraint types (`types.h:150-190`)
ODOMETRY = 0
LOOP_APPEARANCE = 1
MINI_LOOP = 2
CANDIDATE = 3

#: robust kernel applied to LOOP_APPEARANCE / MINI_LOOP edges during
#: optimization (odometry edges stay quadratic — they are the trusted
#: backbone; a single surviving false-positive loop closure must not fold
#: the trajectory). "Cauchy"/"Huber"/"DCS"/"None"; the limit is in
#: whitened (Mahalanobis) units. Measured on the 40-node noisy ring
#: (tests/test_slam_robustness.py), 15 GN iters WITH the GNC schedule
#: below: quadratic folds to ATE 12.5 with one wrong edge; Cauchy(1)
#: contains it at 0.97; DCS contains it at 0.26 = the clean-graph ATE,
#: and is insensitive across lim 1-9 / gnc_start 30-300. DCS's hard
#: redescending rejection needs GNC to converge from large drift (without
#: it, clean-graph ATE degrades to 1.7).
DEFAULT_LOOP_LOSS = "DCS"
DEFAULT_LOOP_LOSS_LIMIT = 4.0
#: graduated non-convexity (Yang et al., RA-L 2020): a redescending kernel
#: at a 1-sigma limit freezes out GENUINE loop edges when odometry drift is
#: large (whitened residual >> limit -> weight ~ 0 -> the optimizer never
#: moves; measured on a 23 m-drift loop world). The optimizers therefore
#: anneal the limit geometrically from `limit * GNC_START` down to `limit`
#: across GN iterations: early iterations are near-quadratic (big basin),
#: late iterations fully robust (outlier rejection at convergence).
DEFAULT_GNC_START = 100.0
#: per-edge robust-limit drift model (mirrors the loop-closure
#: odometry-consistency gate, LoopCloserConfig.max_drift_fraction/
#: drift_slack_m): a VERIFIED loop edge's correction is expected to be as
#: large as the odometry drift accumulated along the chain between its
#: nodes, so its robust limit scales with the whitened square of that
#: allowance — the kernel rejects corrections far BEYOND the drift budget
#: (aliasing), not corrections stiff information makes look huge. Without
#: this, a correct bounded kernel must treat a genuine 20 m-drift closure
#: as an outlier (measured: the 23 m circular-loop world's closure edge
#: carries s~4e4 against a final limit of 4 — weight ~1e-8).
DRIFT_FRACTION = 0.15
DRIFT_SLACK_M = 5.0
#: absolute cap on the translation allowance: the linear model grows
#: unbounded with chain distance, and beyond a few laps almost ANY
#: aliased match falls inside its own budget (measured on the 1400-node
#: ring: a 240 m-wrong edge 1240 chain-m away got allowance 191 m and
#: folded the map). A functioning odometry does not accumulate more than
#: a few tens of meters before place recognition fires; corrections
#: beyond the cap must earn their way in through the annealed phase.
DRIFT_ALLOW_CAP_M = 25.0
DRIFT_YAW_SLACK_RAD = 0.05
DRIFT_YAW_PER_M = 0.002
#: cap on the WHITENED squared allowance. The robust kernel's saturation
#: bound (the total cost credit one edge can offer) scales with its
#: limit, so an uncapped whitened allowance lets a STIFF wrong edge
#: (huge information x in-cap metric allowance) offer enough credit to
#: out-bid the odometry deformation cost of folding the chain (measured:
#: poisoned-ring edge with 10x information folded the map to ATE 13).
#: The cap bounds the saturation credit at 3*cap/2 = 3000 whitened
#: units: far above the odometry deformation cost of a GENUINE correction
#: (redistributing true drift along the chain costs ~the noise floor,
#: tens of units) and below the fold cost of satisfying a wrong edge
#: even on a SOFT chain (measured on the info=100 noisy ring: fold cost
#: ~6e3; a 2e4 cap made the fold profitable and ATE exploded to 13).
#: In-envelope edges beyond the cap pull with reduced weight and simply
#: take more iterations.
S_ALLOW_CAP = 2.0e3


class PoseGraph(NamedTuple):
    """Fixed-shape pose graph (padded, masked)."""

    poses: jax.Array       # (N, 3) node poses [x, y, yaw]
    node_valid: jax.Array  # (N,) bool
    edge_i: jax.Array      # (E,) int32 id_begin
    edge_j: jax.Array      # (E,) int32 id_end
    t_ij: jax.Array        # (E, 3) measured relative pose (i -> j)
    sqrt_info: jax.Array   # (E, 3, 3) square-root information
    edge_type: jax.Array   # (E,) int32
    edge_valid: jax.Array  # (E,) bool
    #: (E,) f32 per-edge robust-limit multiplier (1 for odometry edges;
    #: for loop edges max(1, s_allowance/limit) with s_allowance the
    #: whitened square of the expected-drift allowance — see to_arrays)
    loop_scale: jax.Array = None


def edge_residuals(poses, graph: PoseGraph,
                   loop_loss: str = DEFAULT_LOOP_LOSS,
                   loop_loss_limit: float = DEFAULT_LOOP_LOSS_LIMIT):
    """(E, 3) weighted residuals (zeros for invalid edges).

    CANDIDATE edges (unverified loop proposals, `types.h:150-190`) are
    stored in the graph but NEVER optimized — masked to zero here.
    LOOP_APPEARANCE / MINI_LOOP edges are robustified with the IRLS
    square-root weight sqrt(rho'(||r||^2)): the weight is stop_gradient'd,
    so jvp/vjp through this function implement the standard
    constant-weight-per-GN-step robust Gauss-Newton (Triggs et al.)."""
    pi = poses[graph.edge_i]
    pj = poses[graph.edge_j]
    rel = se2.relative(pi, pj)
    d = rel - graph.t_ij
    d = d.at[:, 2].set(se2.normalize_angle(d[:, 2]))
    r = jnp.einsum("eab,eb->ea", graph.sqrt_info, d)
    active = graph.edge_valid & (graph.edge_type != CANDIDATE)
    if loop_loss != "None":
        s = jnp.sum(jax.lax.stop_gradient(r) ** 2, -1)
        _, drho = losses.rho(s, loop_loss,
                             loop_loss_limit * _edge_scale(graph))
        is_loop = ((graph.edge_type == LOOP_APPEARANCE)
                   | (graph.edge_type == MINI_LOOP))
        w = jnp.where(is_loop, jnp.sqrt(jnp.maximum(drho, 0.0)), 1.0)
        r = r * jax.lax.stop_gradient(w)[:, None]
    return jnp.where(active[:, None], r, 0.0)


def _edge_scale(graph: PoseGraph):
    # per-edge robust-limit multiplier (1.0 when the graph carries none)
    if graph.loop_scale is None:
        return 1.0
    return graph.loop_scale


def robust_cost(poses, graph: PoseGraph,
                loop_loss: str = DEFAULT_LOOP_LOSS,
                loop_loss_limit: float = DEFAULT_LOOP_LOSS_LIMIT):
    """The TRUE robust objective: sum of 0.5*s for odometry edges and
    0.5*rho(s) for loop edges (s = squared whitened residual).

    This — not the IRLS-WEIGHTED residual norm — is what step acceptance
    must compare: a redescending kernel's weighted residual w(s)^2 * s
    DECREASES as a loop residual grows past the limit, so accepting steps
    on it lets the optimizer 'improve' by throwing genuine loops to
    infinity (measured: a 1400-node solve walked from ATE 4.5 to 73 m
    through strictly 'decreasing' weighted costs)."""
    pi = poses[graph.edge_i]
    pj = poses[graph.edge_j]
    rel = se2.relative(pi, pj)
    d = rel - graph.t_ij
    d = d.at[:, 2].set(se2.normalize_angle(d[:, 2]))
    r = jnp.einsum("eab,eb->ea", graph.sqrt_info, d)
    s = jnp.sum(r * r, -1)
    active = graph.edge_valid & (graph.edge_type != CANDIDATE)
    if loop_loss != "None":
        rho, _ = losses.rho(s, loop_loss,
                            loop_loss_limit * _edge_scale(graph))
        is_loop = ((graph.edge_type == LOOP_APPEARANCE)
                   | (graph.edge_type == MINI_LOOP))
        cost_e = jnp.where(is_loop, rho, s)
    else:
        cost_e = s
    return 0.5 * jnp.sum(jnp.where(active, cost_e, 0.0))


def _gauge_fix(x):
    return x.at[0].set(0.0)


def hessian_diag_blocks(poses, graph: PoseGraph,
                        loop_loss: str = DEFAULT_LOOP_LOSS,
                        loop_loss_limit: float = DEFAULT_LOOP_LOSS_LIMIT,
                        num_nodes: int | None = None):
    """(N, 3, 3) diagonal blocks of the GN Hessian J^T J.

    The block-Jacobi PRECONDITIONER of the matrix-free CG solve: plain CG
    on a pose chain needs O(N) iterations for the long-wavelength modes
    (measured at 1400 nodes: cg=200 leaves the loop corrections
    essentially unapplied, ATE 4.59 vs 1.17 at cg=3000), while
    block-Jacobi PCG converges in O(100) regardless of N. Exact per-edge
    3x3 jacobians via vmapped jacfwd, weighted by the SAME IRLS robust
    weights as `edge_residuals`, accumulated per node with two
    segment-sums."""
    n = num_nodes or poses.shape[0]
    pi = poses[graph.edge_i]
    pj = poses[graph.edge_j]

    def res_e(a, b, tij, sqrt_i):
        rel = se2.relative(a, b)
        d = rel - tij
        d = d.at[2].set(se2.normalize_angle(d[2]))
        return sqrt_i @ d

    ji = jax.vmap(jax.jacfwd(res_e, argnums=0))(
        pi, pj, graph.t_ij, graph.sqrt_info)          # (E, 3, 3)
    jj = jax.vmap(jax.jacfwd(res_e, argnums=1))(
        pi, pj, graph.t_ij, graph.sqrt_info)
    r = jax.vmap(res_e)(pi, pj, graph.t_ij, graph.sqrt_info)
    active = graph.edge_valid & (graph.edge_type != CANDIDATE)
    w = active.astype(poses.dtype)
    if loop_loss != "None":
        s = jnp.sum(r ** 2, -1)
        _, drho = losses.rho(s, loop_loss,
                             loop_loss_limit * _edge_scale(graph))
        is_loop = ((graph.edge_type == LOOP_APPEARANCE)
                   | (graph.edge_type == MINI_LOOP))
        w = w * jnp.where(is_loop, jnp.maximum(drho, 0.0), 1.0)
    bi = (jnp.einsum("eab,eac->ebc", ji, ji)
          * w[:, None, None]).reshape(-1, 9)
    bj = (jnp.einsum("eab,eac->ebc", jj, jj)
          * w[:, None, None]).reshape(-1, 9)
    blocks = jax.ops.segment_sum(bi, graph.edge_i, num_segments=n) \
        + jax.ops.segment_sum(bj, graph.edge_j, num_segments=n)
    return blocks.reshape(n, 3, 3)


def _block_jacobi_apply(blocks, damping: float):
    """Returns M^{-1}x for M = blockdiag(H) + damping I (gauge node 0 =
    identity so the preconditioner matches the gauge-fixed operator)."""
    m = blocks + damping * jnp.eye(3, dtype=blocks.dtype)
    m = m.at[0].set(jnp.eye(3, dtype=blocks.dtype))
    minv = jnp.linalg.inv(m)

    def apply(x):
        return jnp.einsum("nab,nb->na", minv, x)

    return apply


def gn_step(poses, graph: PoseGraph, cg_iters: int = 50, damping: float = 1e-6,
            loop_loss: str = DEFAULT_LOOP_LOSS,
            loop_loss_limit: float = DEFAULT_LOOP_LOSS_LIMIT):
    """One Gauss-Newton step: solve (J^T J + lam I) dx = -J^T r by
    block-Jacobi preconditioned matrix-free CG."""

    def res_fn(p):
        return edge_residuals(p, graph, loop_loss, loop_loss_limit)

    r, vjp = jax.vjp(res_fn, poses)
    (grad,) = vjp(r)
    grad = _gauge_fix(grad)

    def hvp(x):
        x = _gauge_fix(x)
        _, jv = jax.jvp(res_fn, (poses,), (x,))
        (h,) = vjp(jv)
        return _gauge_fix(h) + damping * x

    blocks = hessian_diag_blocks(poses, graph, loop_loss, loop_loss_limit)
    precond = _block_jacobi_apply(blocks, damping)
    dx = _gauge_fix(_pcg(hvp, -grad, precond, cg_iters))
    cost = 0.5 * jnp.sum(r * r)

    # damped acceptance: a FULL Gauss-Newton step under fast-shifting IRLS
    # weights (the GNC anneal) can overshoot and diverge (measured: more-
    # converged CG made a 1400-node solve WORSE). Evaluate a tiny
    # backtracking ladder {1, 1/2, 1/4, 0} on the TRUE robust cost (see
    # `robust_cost` — NOT the weighted residual norm, which redescending
    # kernels let decrease to 'reward' exploding loop residuals) and keep
    # the best; the zero step guarantees per-iteration monotonicity.
    def cost_at(p2):
        return robust_cost(p2, graph, loop_loss, loop_loss_limit)

    # the GN direction is a DESCENT direction for the true robust cost
    # (the IRLS-weighted gradient equals the robust gradient), so small
    # enough rungs always progress — without the sub-0.25 rungs a large
    # loop correction (23 m + rotation) overshoots at every ladder step
    # and the solve freezes on the zero candidate
    ladder = (1.0, 0.5, 0.25, 0.1, 0.04, 0.01)
    alphas = jnp.asarray(ladder + (0.0,), poses.dtype)
    costs = jnp.stack([cost_at(poses + a * dx) for a in ladder]
                      + [cost_at(poses)])
    best = jnp.argmin(costs)
    new_poses = poses + alphas[best] * dx
    return new_poses, cost, jnp.linalg.norm(grad)


def _cg(matvec, b, iters: int):
    """Plain conjugate gradients (fixed iteration count, jit-friendly)."""

    def body(_, state):
        x, r, p, rs = state
        Ap = matvec(p)
        denom = jnp.sum(p * Ap)
        alpha = rs / jnp.where(denom > 0, denom, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.sum(r * r)
        beta = rs_new / jnp.where(rs > 0, rs, 1.0)
        p = r + beta * p
        return x, r, p, rs_new

    x0 = jnp.zeros_like(b)
    state = (x0, b, b, jnp.sum(b * b))
    x, *_ = jax.lax.fori_loop(0, iters, body, state)
    return x


def _pcg(matvec, b, precond, iters: int):
    """Preconditioned conjugate gradients (fixed trip count)."""

    def body(_, state):
        x, r, p, rz = state
        Ap = matvec(p)
        denom = jnp.sum(p * Ap)
        alpha = rz / jnp.where(denom > 0, denom, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.where(jnp.abs(rz) > 0, rz, 1.0)
        p = z + beta * p
        return x, r, p, rz_new

    x0 = jnp.zeros_like(b)
    z0 = precond(b)
    state = (x0, b, z0, jnp.sum(b * z0))
    x, *_ = jax.lax.fori_loop(0, iters, body, state)
    return x


def gnc_limit(k, iters: int, limit: float,
              gnc_start=DEFAULT_GNC_START, anneal_len: int = 16):
    """Annealed robust-kernel limit at GN iteration k (traced-safe):
    geometric from limit*gnc_start (k=0) down to limit over the first
    min(iters, anneal_len) iterations, then HELD at limit.

    The hold matters: while the limit changes, per-iteration monotone
    acceptance is monotone in a MOVING objective, and long schedules let
    the solve walk to the odometry-only minimum through strictly
    'improving' steps (measured: a 1400-node solve at 15 iters converged
    to ATE 1.8 but at 40 iters walked to 32 m). Capping the anneal bounds
    that risk window; every post-anneal iteration optimizes the FIXED
    final objective, where the zero-step ladder candidate guarantees real
    monotonicity. `gnc_start` may be a traced scalar (adaptive start).
    At most HALF the iterations anneal, so every run ends with a
    fixed-kernel recovery phase — an outlier edge that the (possibly
    contaminated) adaptive start lets fold the map early is rejected at
    the final limit and the fold undone (measured on the poisoned-ring
    test: 15 all-annealing iterations end at ATE 6.1; 7 annealing + 8
    recovery iterations reconverge to the clean-graph 0.29)."""
    # fewer than 4 iterations cannot fit an anneal + recovery split:
    # run every iteration at the FIXED final limit (the old behavior for
    # iters<=1; forcing n_anneal=2 would spend a single-iteration solve
    # entirely at the inflated start limit)
    n_anneal = min(iters // 2, anneal_len)
    if n_anneal <= 1:
        return jnp.asarray(limit, jnp.float32)
    kk = jnp.minimum(k.astype(jnp.float32), float(n_anneal - 1))
    frac = 1.0 - kk / (n_anneal - 1)
    start = jnp.maximum(jnp.asarray(gnc_start, jnp.float32), 1.0)
    return limit * start ** frac


def adaptive_gnc_start(poses, graph: PoseGraph, loop_loss_limit: float,
                       gnc_start: float = DEFAULT_GNC_START):
    """Data-dependent graduated-non-convexity start.

    The anneal must BEGIN above the squared whitened residuals of the
    GENUINE loop edges, or the first GN iterations already crush their
    IRLS weights and the optimizer never applies the loop corrections
    (measured at 1400 nodes with stiff ~1e4 information: initial whitened
    loop residuals^2 ~ 1.6e4 vs the static start 4*100 = 400 -> DCS
    weight ~0.002 from iteration 0, ATE unchanged). Returns
    max(gnc_start, 2 * q90(s_loop) / limit) with s_loop the initial
    whitened squared loop residuals — so the first iteration is
    near-quadratic for >=90% of loop edges while true outliers (aliased
    matches, typically orders of magnitude larger) still anneal out."""
    r0 = edge_residuals(poses, graph, loop_loss="None")
    s0 = jnp.sum(r0 ** 2, -1) / _edge_scale(graph)   # limit-normalized
    is_loop = ((graph.edge_type == LOOP_APPEARANCE)
               | (graph.edge_type == MINI_LOOP)) & graph.edge_valid
    q90 = jnp.nanquantile(jnp.where(is_loop, s0, jnp.nan), 0.9)
    start = jnp.where(jnp.isnan(q90), gnc_start,
                      jnp.maximum(gnc_start, 2.0 * q90 / loop_loss_limit))
    return start.astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("iters", "cg_iters",
                                             "loop_loss", "loop_loss_limit",
                                             "gnc_start"))
def optimize(graph: PoseGraph, iters: int = 10, cg_iters: int = 50,
             loop_loss: str = DEFAULT_LOOP_LOSS,
             loop_loss_limit: float = DEFAULT_LOOP_LOSS_LIMIT,
             gnc_start: float = DEFAULT_GNC_START):
    """Gauss-Newton pose-graph optimization (single device) with graduated
    non-convexity on the loop-edge robust kernel (see `DEFAULT_GNC_START`
    and `adaptive_gnc_start` — the anneal start adapts to the initial
    loop-residual scale so stiff information matrices don't freeze the
    loops out), solved by block-Jacobi preconditioned matrix-free CG."""
    # with per-edge drift-scaled limits (loop_scale) the genuine edges are
    # in-kernel at the FINAL limit by construction, so only a MILD anneal
    # is wanted (a big start would re-admit outliers the scales exclude);
    # the residual-quantile adaptive start is for scale-less graphs only
    if loop_loss == "None":
        start = jnp.asarray(gnc_start, jnp.float32)
    elif graph.loop_scale is not None:
        # NO anneal: the per-edge limits already admit every in-envelope
        # correction at full weight from iteration 0, and any anneal
        # inflation re-admits the out-of-envelope outliers the scales
        # exclude (measured: start=10 folded the poisoned ring to ATE 14
        # in two iterations and the recovery oscillated; start=1 keeps
        # the objective FIXED so the ladder's monotonicity is global)
        start = jnp.asarray(1.0, jnp.float32)
    else:
        start = adaptive_gnc_start(graph.poses, graph, loop_loss_limit,
                                   gnc_start)

    def body(k, carry):
        poses, _ = carry
        poses, cost, _ = gn_step(poses, graph, cg_iters,
                                 loop_loss=loop_loss,
                                 loop_loss_limit=gnc_limit(
                                     k, iters, loop_loss_limit, start))
        return poses, cost

    poses, cost = jax.lax.fori_loop(
        0, iters, body, (graph.poses, jnp.asarray(0.0, graph.poses.dtype)))
    return graph._replace(poses=poses), cost


def total_cost(graph: PoseGraph, loop_loss: str = DEFAULT_LOOP_LOSS,
               loop_loss_limit: float = DEFAULT_LOOP_LOSS_LIMIT):
    r = edge_residuals(graph.poses, graph, loop_loss, loop_loss_limit)
    return 0.5 * jnp.sum(r * r)


# ---------------------------------------------------------------------------
# host-side graph construction / serialization (simple_graph equivalent)
# ---------------------------------------------------------------------------

#: per-node scan payload fields (the information content of the reference's
#: serialized `RadarScan`, `types.h:93-143`: peaks cloud + full filtered
#: cloud + oriented-surface-point map + inter-frame motion)
SCAN_FIELDS = ("peaks_xy", "peaks_intensity", "cloud_xy", "cloud_intensity",
               "cell_mean", "cell_normal", "cell_cov", "cell_nsamples",
               "cell_planarity", "motion")


@dataclasses.dataclass
class GraphBuilder:
    """Accumulates keyframe poses + constraints + scan payloads; the `.sgh`
    role is played by an npz archive (`save`/`load`), the hand-off artifact
    for SLAM back-ends (reference `SaveSimpleGraph`, `types.cpp:103-130`).
    Carries the full information content of the reference's `simple_graph`:
    per-node `RadarScan` payload (peaks cloud, filtered cloud, cell map,
    motion; `types.h:93-143`) and per-type constraint accounting with the
    `ConstraintsHandler` map semantics (`types.cpp:133-226`)."""

    poses: list = dataclasses.field(default_factory=list)
    stamps: list = dataclasses.field(default_factory=list)
    gt_poses: list = dataclasses.field(default_factory=list)
    has_gt: list = dataclasses.field(default_factory=list)
    edges: list = dataclasses.field(default_factory=list)  # (i, j, tij, info, type)
    scans: list = dataclasses.field(default_factory=list)  # dict | None per node
    #: per-edge quality metrics keyed by position in `edges` — the
    #: `Constraint3d::quality` map (`types.h:176-190`; TBV-SLAM fills it with
    #: verification scores). Keys here: "score", "num_assoc", "yaw_seed",
    #: "ring_distance" from the loop closer.
    quality: dict = dataclasses.field(default_factory=dict)
    # ConstraintsHandler accounting: (type, (min,max)) -> position in edges,
    # and accumulated odometry translation (`types.cpp:158-160`)
    _index: dict = dataclasses.field(default_factory=dict)
    _dist_trav: float = 0.0

    def add_node(self, pose, stamp: float = 0.0) -> int:
        self.poses.append(np.asarray(pose, np.float64))
        self.stamps.append(float(stamp))
        self.gt_poses.append(np.zeros(3))
        self.has_gt.append(False)
        self.scans.append(None)
        return len(self.poses) - 1

    def add_scan_payload(self, node: int, **fields) -> None:
        """Attach the `RadarScan` content to a node (`types.h:118-122`):
        peaks_xy/peaks_intensity, cloud_xy/cloud_intensity, cell_* arrays
        (valid cells only), motion (3,)."""
        unknown = set(fields) - set(SCAN_FIELDS)
        if unknown:
            raise ValueError(f"unknown scan fields {sorted(unknown)}")
        self.scans[node] = {k: np.asarray(v) for k, v in fields.items()}

    # -- ConstraintsHandler semantics (`types.cpp:133-226`) ----------------
    def _add_constraint(self, i: int, j: int, t_ij, info, kind: int,
                        quality: dict | None = None):
        if i == j:
            raise ValueError("self-constraint not allowed (types.cpp:168)")
        key = (kind, (min(i, j), max(i, j)))
        edge = (i, j, np.asarray(t_ij, np.float64), info, kind)
        if kind == ODOMETRY:   # dist_trav accumulates per Add call
            self._dist_trav += float(np.linalg.norm(edge[2][:2]))
        pos = self._index.get(key)
        if pos is None:        # map insert-or-overwrite (`types.cpp:161`)
            pos = len(self.edges)
            self._index[key] = pos
            self.edges.append(edge)
        else:
            self.edges[pos] = edge
        if quality is not None:
            self.quality[pos] = {k: float(v) for k, v in quality.items()}

    def add_odometry_edge(self, i: int, j: int, cov3: np.ndarray):
        """Odometry constraint j -> i with information cov^-1
        (`AddToGraph`, `odometrykeyframefuser.cpp:428-445`)."""
        t_ij = np.asarray(se2.relative(
            jnp.asarray(self.poses[i]), jnp.asarray(self.poses[j])))
        info = np.linalg.inv(cov3 + 1e-12 * np.eye(3))
        self._add_constraint(i, j, t_ij, info, ODOMETRY)

    def add_loop_edge(self, i: int, j: int, t_ij, cov3,
                      kind: int = LOOP_APPEARANCE,
                      quality: dict | None = None):
        info = np.linalg.inv(np.asarray(cov3) + 1e-12 * np.eye(3))
        self._add_constraint(i, j, t_ij, info, kind, quality)

    def n_constraints(self, kind: int = ODOMETRY) -> int:
        """`ConstraintsHandler::size` (`types.h:234`)."""
        return sum(1 for e in self.edges if e[4] == kind)

    def find_constraint(self, i: int, j: int, kind: int = ODOMETRY):
        """`FindConstraint` (`types.cpp:183-193`): unordered (i, j) lookup."""
        pos = self._index.get((kind, (min(i, j), max(i, j))))
        return None if pos is None else self.edges[pos]

    def constraint_exists(self, i: int, j: int, kind: int = ODOMETRY) -> bool:
        return self.find_constraint(i, j, kind) is not None

    def has_constraint_type(self, node: int, kind: int) -> bool:
        """`HasConstraintType` (`types.cpp:175-181`)."""
        return any(e[4] == kind and (e[0] == node or e[1] == node)
                   for e in self.edges)

    def relative_motion(self, i: int, j: int, kind: int = ODOMETRY):
        """`RelativeMotion` (`types.cpp:213-222`): identity if absent."""
        e = self.find_constraint(i, j, kind)
        return np.zeros(3) if e is None else np.asarray(e[2])

    def relative_distance(self, i: int, j: int) -> float:
        """`RelativeDistance` (`types.cpp:223-231`): summed odometry-chain
        translation between the two nodes."""
        lo, hi = min(i, j), max(i, j)
        return float(sum(np.linalg.norm(self.relative_motion(k, k + 1)[:2])
                         for k in range(lo, hi)))

    def chain_distances(self) -> np.ndarray:
        """Prefix sums of odometry-edge lengths: (K,) with
        `relative_distance(i, j) == |out[i] - out[j]|`. Computed once in
        O(K) so per-pair queries (the loop-closure proposal stage runs
        O(K * candidates) of them) are O(1) instead of an O(K) chain walk
        each — the difference between seconds and minutes at the ~2000
        keyframes of a full Oxford sequence."""
        n = len(self.poses)
        seg = np.zeros(n)
        for k in range(n - 1):
            seg[k + 1] = np.linalg.norm(self.relative_motion(k, k + 1)[:2])
        return np.cumsum(seg)

    def distance_traveled(self) -> float:
        """`DistanceTraveled` (`types.h:236`): mean odometry-edge length."""
        return self._dist_trav / (0.1 + self.n_constraints(ODOMETRY))

    def to_string(self) -> str:
        """`ConstraintsHandler::ToString` (`types.cpp:142-144`)."""
        return (f"odom constraints: {self.n_constraints(ODOMETRY)}, "
                f"loop constraints: {self.n_constraints(LOOP_APPEARANCE)}\n")

    def attach_ground_truth(self, stamps, gt_xyt, tol: float = 1e-4):
        """Match GT poses to nodes by timestamp (`AddGroundTruth`,
        `odometrykeyframefuser.cpp:446-463`)."""
        stamps = np.asarray(stamps)
        for k, t in enumerate(self.stamps):
            d = np.abs(stamps - t)
            m = int(np.argmin(d))
            if d[m] <= tol:
                self.gt_poses[k] = np.asarray(gt_xyt[m], np.float64)
                self.has_gt[k] = True

    def to_arrays(self, max_nodes: Optional[int] = None,
                  max_edges: Optional[int] = None,
                  dtype=jnp.float32) -> PoseGraph:
        n = len(self.poses)
        e = len(self.edges)
        nn = max_nodes or n
        ee = max_edges or max(e, 1)
        poses = np.zeros((nn, 3))
        poses[:n] = np.stack(self.poses) if n else 0
        ei = np.zeros(ee, np.int32)
        ej = np.zeros(ee, np.int32)
        tij = np.zeros((ee, 3))
        sinfo = np.zeros((ee, 3, 3))
        etype = np.zeros(ee, np.int32)
        lscale = np.ones(ee, np.float32)
        cum = self.chain_distances() if n else np.zeros(0)
        for k, (i, j, t, info, kind) in enumerate(self.edges[:ee]):
            ei[k], ej[k] = i, j
            tij[k] = t
            s = (np.asarray(info, np.float64)
                 + np.asarray(info, np.float64).T) / 2
            # a degraded registration can hand over an INDEFINITE
            # information matrix (f32 Censi-scaled inverse Hessian near a
            # saddle — observed on dropout-heavy worlds); clip its
            # eigenvalues to a small positive floor so the square-root
            # information exists and the edge only constrains its
            # well-conditioned directions (the reference's analogue is
            # discarding non-convex sampled covariances,
            # `odometrykeyframefuser.cpp:350-359`)
            w, v = np.linalg.eigh(s)
            floor = max(1e-9, 1e-9 * float(np.max(np.abs(w), initial=0.0)))
            s = (v * np.clip(w, floor, None)) @ v.T
            sinfo[k] = np.linalg.cholesky(s).T
            etype[k] = kind
            if kind in (LOOP_APPEARANCE, MINI_LOOP):
                # per-edge robust-limit scale from the expected-odometry-
                # drift allowance between the nodes (see DRIFT_* above):
                # a verified closure correcting <= the drift budget stays
                # fully in-kernel at the FINAL annealed limit; only
                # corrections far beyond it (aliasing scale) redescend
                d_chain = abs(cum[i] - cum[j])
                allow_t = min(DRIFT_FRACTION * d_chain + DRIFT_SLACK_M,
                              DRIFT_ALLOW_CAP_M)
                allow = np.array([
                    allow_t, allow_t,
                    min(DRIFT_YAW_SLACK_RAD + DRIFT_YAW_PER_M * d_chain,
                        0.35)])
                s_allow = min(float(np.sum((sinfo[k] @ allow) ** 2)),
                              S_ALLOW_CAP)
                lscale[k] = max(1.0, s_allow / DEFAULT_LOOP_LOSS_LIMIT)
        return PoseGraph(
            poses=jnp.asarray(poses, dtype),
            node_valid=jnp.asarray(np.arange(nn) < n),
            edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
            t_ij=jnp.asarray(tij, dtype),
            sqrt_info=jnp.asarray(sinfo, dtype),
            edge_type=jnp.asarray(etype),
            edge_valid=jnp.asarray(np.arange(ee) < e),
            loop_scale=jnp.asarray(lscale),
        )

    def save(self, path: str) -> None:
        """Serialize the full simple_graph content (poses, constraints, and
        per-node scan payloads) to one npz. Ragged per-node arrays are
        stored concatenated with `<field>_offsets` prefix-sum indices."""
        payload = dict(
            poses=np.stack(self.poses) if self.poses else np.zeros((0, 3)),
            stamps=np.asarray(self.stamps),
            gt_poses=np.stack(self.gt_poses) if self.gt_poses else np.zeros((0, 3)),
            has_gt=np.asarray(self.has_gt),
            edge_i=np.asarray([e[0] for e in self.edges], np.int64),
            edge_j=np.asarray([e[1] for e in self.edges], np.int64),
            t_ij=np.stack([e[2] for e in self.edges]) if self.edges else np.zeros((0, 3)),
            info=np.stack([e[3] for e in self.edges]) if self.edges else np.zeros((0, 3, 3)),
            edge_type=np.asarray([e[4] for e in self.edges], np.int64),
            has_scan=np.asarray([s is not None for s in self.scans], bool),
        )
        if self.quality:
            import json
            payload["edge_quality_json"] = np.asarray(
                json.dumps({str(k): v for k, v in self.quality.items()}))
        if any(s is not None for s in self.scans):
            for f in SCAN_FIELDS:
                parts = [s[f] for s in self.scans
                         if s is not None and f in s]
                if not parts:
                    continue
                lens = [len(s[f]) if s is not None and f in s else 0
                        for s in self.scans]
                payload["scan_" + f] = np.concatenate(parts, axis=0)
                payload["scan_" + f + "_offsets"] = np.concatenate(
                    [[0], np.cumsum(lens)]).astype(np.int64)
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path: str) -> "GraphBuilder":
        z = np.load(path)
        gb = cls()
        gb.poses = list(z["poses"])
        gb.stamps = list(z["stamps"])
        gb.gt_poses = list(z["gt_poses"])
        gb.has_gt = list(z["has_gt"])
        gb.edges = [(int(i), int(j), t, inf, int(k))
                    for i, j, t, inf, k in zip(z["edge_i"], z["edge_j"],
                                               z["t_ij"], z["info"],
                                               z["edge_type"])]
        for pos, e in enumerate(gb.edges):  # rebuild accounting index
            key = (e[4], (min(e[0], e[1]), max(e[0], e[1])))
            gb._index.setdefault(key, pos)
            if e[4] == ODOMETRY:
                gb._dist_trav += float(np.linalg.norm(e[2][:2]))
        if "edge_quality_json" in z.files:
            import json
            gb.quality = {int(k): v for k, v in
                          json.loads(str(z["edge_quality_json"])).items()}
        has_scan = z["has_scan"] if "has_scan" in z.files \
            else np.zeros(len(gb.poses), bool)
        gb.scans = [None] * len(gb.poses)
        for f in SCAN_FIELDS:
            key = "scan_" + f
            if key not in z.files:
                continue
            flat, offs = z[key], z[key + "_offsets"]
            for n in range(len(gb.poses)):
                if not has_scan[n]:
                    continue
                if gb.scans[n] is None:
                    gb.scans[n] = {}
                gb.scans[n][f] = flat[offs[n]:offs[n + 1]]
        return gb


def compute_scan_payloads(images: np.ndarray, frame_ids, cfg,
                          motions: np.ndarray | None = None) -> list:
    """Recompute each keyframe's `RadarScan` payload (`types.h:118-122`)
    from the raw sweeps: peaks cloud, full filtered cloud, oriented
    surface points (all in the compensated sensor-local frame the pipeline
    registered with), and the inter-frame motion used for compensation
    (`motions` (K, 3); zeros disable compensation).

    Runs as ONE jitted hand-batched pass per chunk of keyframes (the
    feature stage shares a single scatter across lanes)."""
    import jax
    import jax.numpy as jnp
    from cfear_jax.ops import features, filtering
    from cfear_jax.utils import se2 as _se2

    frame_ids = list(frame_ids)
    if motions is None:
        motions = np.zeros((len(frame_ids), 3), np.float32)
    motions = np.asarray(motions, np.float32)

    @jax.jit
    def extract(imgs, tmots):
        pts = jax.vmap(
            lambda im: filtering.filter_polar_image(im, cfg))(imgs)
        if cfg.odometry.compensate:
            xy = jax.vmap(
                lambda p, t: _se2.compensate_points(p, t, cfg.radar.ccw))(
                    pts.xy, tmots)
            pts = pts._replace(xy=xy)
        cells = features.compute_cells_batched(pts, cfg)
        return pts, cells

    payloads = []
    chunk = 16
    for lo in range(0, len(frame_ids), chunk):
        ids = frame_ids[lo:lo + chunk]
        imgs = jnp.asarray(np.stack([images[f] for f in ids]))
        pts, cells = extract(imgs, jnp.asarray(motions[lo:lo + chunk]))
        pts, cells = jax.tree.map(np.asarray, (pts, cells))
        for n in range(len(ids)):
            v = pts.valid[n]
            pk = pts.peak[n]
            cv = cells.valid[n]
            payloads.append(dict(
                peaks_xy=pts.xy[n][pk].astype(np.float32),
                peaks_intensity=pts.intensity[n][pk].astype(np.float32),
                cloud_xy=pts.xy[n][v].astype(np.float32),
                cloud_intensity=pts.intensity[n][v].astype(np.float32),
                cell_mean=cells.mean[n][cv].astype(np.float32),
                cell_normal=cells.normal[n][cv].astype(np.float32),
                cell_cov=cells.cov[n][cv].astype(np.float32),
                cell_nsamples=cells.nsamples[n][cv].astype(np.float32),
                cell_planarity=cells.planarity[n][cv].astype(np.float32),
                motion=motions[lo + n],
            ))
    return payloads


def payload_to_cellmap(scan: dict, max_cells: int):
    """Rebuild a fixed-size `CellMap` from a stored scan payload."""
    import jax.numpy as jnp
    from cfear_jax.ops.features import CellMap

    n = min(len(scan["cell_mean"]), max_cells)

    def pad(a, shape):
        out = np.zeros((max_cells,) + shape, np.float32)
        out[:n] = a[:n]
        return jnp.asarray(out)

    valid = np.zeros(max_cells, bool)
    valid[:n] = True
    return CellMap(
        mean=pad(scan["cell_mean"], (2,)),
        normal=pad(scan["cell_normal"], (2,)),
        cov=pad(scan["cell_cov"], (2, 2)),
        nsamples=pad(scan["cell_nsamples"], ()),
        planarity=pad(scan["cell_planarity"], ()),
        valid=jnp.asarray(valid),
    )


def build_graph_from_odometry(outputs, trajectory_xyt, stamps=None,
                              images=None, cfg=None) -> GraphBuilder:
    """Assemble the odometry pose graph from fuser frame outputs
    (keyframe nodes + chained odometry constraints). With `images` and
    `cfg`, each node also carries its scan payload (peaks cloud, filtered
    cloud, cell map, motion), matching the information content of the
    reference's `.sgh` (`types.h:93-143`)."""
    gb = GraphBuilder()
    fused = np.asarray(outputs.fused)
    covs = np.asarray(outputs.cov, np.float64)
    prev = None
    kf_frames = list(np.where(fused)[0])
    for k in kf_frames:
        stamp = float(stamps[k]) if stamps is not None else float(k)
        idx = gb.add_node(trajectory_xyt[k], stamp)
        if prev is not None:
            gb.add_odometry_edge(idx, prev, covs[k])
        prev = idx
    if images is not None and cfg is not None:
        import jax.numpy as jnp
        motions = np.zeros((len(kf_frames), 3), np.float32)
        for n, f in enumerate(kf_frames):
            if f > 0:
                motions[n] = np.asarray(se2.relative(
                    jnp.asarray(trajectory_xyt[f - 1], jnp.float32),
                    jnp.asarray(trajectory_xyt[f], jnp.float32)))
        payloads = compute_scan_payloads(images, kf_frames, cfg,
                                         motions=motions)
        for n, p in enumerate(payloads):
            gb.add_scan_payload(n, **p)
    return gb
