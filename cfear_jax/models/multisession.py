"""Multi-session SLAM: cross-session loop detection + joint optimization.

SURVEY §7 build-order step 8 names "multi-session optimization"; the
reference's role there is to HAND OFF its `simple_graph` to the companion
TBV-SLAM project (`types.h:192-196`, `README.md:150-152`) which fuses
multiple sessions. This module completes that capability in-repo, on the
same artifacts:

1. **Cross-session proposal** — ring-key descriptors (`models/loopclosure`)
   of BOTH sessions' stored scan payloads, matched by one (K_a x K_b)
   cosine-distance matmul; no temporal-separation gate (different sessions
   share no clock).
2. **Verification** — ONE vmapped CFEAR registration over the padded
   candidate batch, seeded with the sector-correlation yaw (there is no
   odometric prior across sessions, so the translation seed is zero).
3. **Rigid pre-alignment** — each verified match (i in A, j in B) implies
   T_ab = T_a_i . t_reg . T_b_j^{-1}; the consensus transform (the match
   agreeing with the most others within a translation/yaw tolerance,
   averaged over its inliers) initializes session B in A's frame. The
   consensus vote is what kills perceptually-aliased matches — an aliased
   pair implies a wildly different T_ab than the true overlaps.
4. **Joint optimization** — one merged graph (A's nodes, then B's nodes
   offset by K_a) carrying both odometry chains and the inter-session
   LOOP_APPEARANCE edges, solved by the GN/CG backend with robust loop
   kernels + GNC — single device (`posegraph.optimize`) or edge-sharded
   over a mesh (`parallel/pgo.distributed_optimize`).

Fixed-shape discipline: descriptors, the proposal matrix, and the
verification batch are fixed-shape batched device ops; only the tiny
consensus vote runs on host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cfear_jax.config import CFEARConfig
from cfear_jax.models import loopclosure, posegraph
from cfear_jax.utils import se2


@dataclasses.dataclass
class MultiSessionConfig:
    #: cosine-distance gate on cross-session ring keys (looser than the
    #: intra-session gate: different sessions see the place with different
    #: speckle/occlusion)
    max_ring_distance: float = 0.35
    max_candidates: int = 3             # per session-B node
    verify_score_max: float = 0.1
    min_assoc: int = 50
    #: consensus tolerances for the rigid pre-alignment vote
    consensus_trans_m: float = 5.0
    consensus_yaw_rad: float = 0.175    # ~10 deg
    #: minimum verified matches to merge at all
    min_matches: int = 2


def _compose_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """SE(2) compose on host float64 (a . b)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1],
                     a[1] + s * b[0] + c * b[1],
                     a[2] + b[2]])


def _inverse_np(a: np.ndarray) -> np.ndarray:
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([-(c * a[0] + s * a[1]), -(-s * a[0] + c * a[1]), -a[2]])


def cross_session_matches(gb_a: posegraph.GraphBuilder,
                          gb_b: posegraph.GraphBuilder,
                          cfg: CFEARConfig,
                          ms: MultiSessionConfig | None = None,
                          lc: loopclosure.LoopCloserConfig | None = None
                          ) -> List[dict]:
    """Verified cross-session scan matches.

    Returns a list of dicts {i_a, j_b, t_ij, cov, score, num_assoc} where
    `t_ij` is the registered pose of B-node j's scan expressed in A-node
    i's scan frame (edge convention of `GraphBuilder.add_odometry_edge`:
    t_ij = T_i^{-1} T_j)."""
    ms = ms or MultiSessionConfig()
    lc = lc or loopclosure.LoopCloserConfig()
    if any(s is None for s in gb_a.scans) or any(s is None for s in gb_b.scans):
        raise ValueError("multi-session matching needs scan payloads on "
                         "every node of both graphs (build with images/cfg)")
    closer = loopclosure.LoopCloser(cfg, lc)
    m = cfg.feature.max_cells
    stack_a = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[posegraph.payload_to_cellmap(s, m) for s in gb_a.scans])
    stack_b = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[posegraph.payload_to_cellmap(s, m) for s in gb_b.scans])
    rk_a, sh_a = jax.tree.map(np.asarray, closer._desc_fn(stack_a))
    rk_b, sh_b = jax.tree.map(np.asarray, closer._desc_fn(stack_b))
    na, nb = rk_a.shape[0], rk_b.shape[0]

    # proposal: (K_a x K_b) cosine distance. Zero-norm (degenerate) ring
    # keys default to similarity 0 -> distance 1, so an empty-scan node
    # can never flood the candidate slots as a "perfect" match
    denom = np.outer(np.linalg.norm(rk_a, axis=-1),
                     np.linalg.norm(rk_b, axis=-1))
    d = 1.0 - np.divide(rk_a @ rk_b.T, denom, out=np.zeros((na, nb)),
                        where=denom > 0)
    pairs = []
    for j in range(nb):
        cand = np.where(d[:, j] < ms.max_ring_distance)[0]
        if cand.size:
            order = np.argsort(d[cand, j])[:ms.max_candidates]
            pairs.extend((int(i), j) for i in cand[order])
    if not pairs:
        return []

    ii = np.asarray([p[0] for p in pairs])
    jj = np.asarray([p[1] for p in pairs])
    # argument order mirrors the intra-session call (SOURCE histogram
    # first): the verification registers kf=A-scan, src=B-scan, and
    # swapping the cross-correlation arguments negates the shift
    yaw = loopclosure._yaws_from_sectors(sh_b[jj], sh_a[ii], lc.n_sectors)
    guesses = np.stack([np.zeros_like(yaw), np.zeros_like(yaw), -yaw],
                       -1).astype(np.float32)
    p2 = len(pairs)
    # chunked verification (fixed batch width, bounded device memory)
    res = closer._verify(stack_a, stack_b, ii, jj, guesses)
    score = res["score"]
    success = res["success"]
    num_assoc = res["num_assoc"]
    rpose = res["pose"]
    rcov = res["cov"]

    matches = []
    for p in range(p2):
        if (success[p] and score[p] < ms.verify_score_max
                and num_assoc[p] >= ms.min_assoc):
            matches.append(dict(
                i_a=int(ii[p]), j_b=int(jj[p]),
                t_ij=rpose[p].astype(np.float64), cov=rcov[p],
                score=float(score[p]), num_assoc=int(num_assoc[p]),
                ring_distance=float(d[ii[p], jj[p]])))
    return matches


def align_from_matches(gb_a: posegraph.GraphBuilder,
                       gb_b: posegraph.GraphBuilder,
                       matches: List[dict],
                       ms: MultiSessionConfig | None = None
                       ) -> Tuple[np.ndarray, List[dict]]:
    """Consensus rigid alignment T_ab (B's frame into A's frame).

    Each match m votes T_ab^m = T_a_i . t_ij . T_b_j^{-1}; the winner is
    the vote agreeing with the most others within the translation/yaw
    tolerance, refined by averaging its inlier set (xy mean + circular yaw
    mean). Returns (t_ab (3,), inlier matches)."""
    ms = ms or MultiSessionConfig()
    if not matches:
        raise ValueError("no cross-session matches to align from")
    votes = []
    for mt in matches:
        ta = np.asarray(gb_a.poses[mt["i_a"]], np.float64)
        tb = np.asarray(gb_b.poses[mt["j_b"]], np.float64)
        votes.append(_compose_np(_compose_np(ta, mt["t_ij"]),
                                 _inverse_np(tb)))
    votes = np.stack(votes)
    dxy = np.linalg.norm(votes[:, None, :2] - votes[None, :, :2], axis=-1)
    dyaw = np.abs(np.angle(np.exp(1j * (votes[:, None, 2]
                                        - votes[None, :, 2]))))
    agree = (dxy <= ms.consensus_trans_m) & (dyaw <= ms.consensus_yaw_rad)
    best = int(np.argmax(agree.sum(1)))
    inl = np.where(agree[best])[0]
    t_ab = np.array([votes[inl, 0].mean(), votes[inl, 1].mean(),
                     np.angle(np.exp(1j * votes[inl, 2]).mean())])
    return t_ab, [matches[k] for k in inl]


def merge_graphs(gb_a: posegraph.GraphBuilder,
                 gb_b: posegraph.GraphBuilder,
                 matches: List[dict],
                 t_ab: np.ndarray) -> posegraph.GraphBuilder:
    """One joint graph: A's nodes (ids unchanged), B's nodes offset by
    K_a and pre-transformed by `t_ab`, both odometry chains, and one
    inter-session LOOP_APPEARANCE edge per verified match."""
    joint = posegraph.GraphBuilder()
    for gb, transform in ((gb_a, None), (gb_b, t_ab)):
        off = len(joint.poses)
        for k in range(len(gb.poses)):
            pose = np.asarray(gb.poses[k], np.float64)
            if transform is not None:
                pose = _compose_np(transform, pose)
            idx = joint.add_node(pose, gb.stamps[k])
            joint.gt_poses[idx] = gb.gt_poses[k]
            joint.has_gt[idx] = gb.has_gt[k]
            if gb.scans[k] is not None:
                joint.scans[idx] = dict(gb.scans[k])
        for pos, (i, j, t_ij, info, kind) in enumerate(gb.edges):
            # carry the per-edge Constraint3d::quality records through
            joint._add_constraint(i + off, j + off, t_ij, info, kind,
                                  quality=gb.quality.get(pos))
    ka = len(gb_a.poses)
    for mt in matches:
        joint.add_loop_edge(
            mt["i_a"], ka + mt["j_b"], mt["t_ij"], mt["cov"],
            kind=posegraph.LOOP_APPEARANCE,
            quality={"score": mt["score"], "num_assoc": mt["num_assoc"],
                     "ring_distance": mt["ring_distance"],
                     "cross_session": 1.0})
    return joint


def merge_many(graphs: List[posegraph.GraphBuilder],
               cfg: CFEARConfig,
               ms: MultiSessionConfig | None = None,
               lc: loopclosure.LoopCloserConfig | None = None,
               mesh=None, iters: int = 15):
    """Incremental N-session merge (the TBV-SLAM multi-session role,
    `types.h:192-196`, `README.md:150-152` — fusing MANY sessions' graphs
    into one map, not just a pair).

    Session k+1 is matched against the ENTIRE joint graph built so far
    (scan payloads are carried through `merge_graphs`, so later sessions
    can close against any earlier session's nodes, not only session 0),
    aligned by the same consensus vote as the pairwise path, and appended.
    A session whose matches lack consensus against the joint graph REFUSES
    to merge (ValueError naming the session index) rather than gluing maps
    at an arbitrary transform. One joint optimization runs at the end.

    Returns (opt_poses (sum K_i, 3), joint GraphBuilder, per-merge info
    list of dicts {session, t_ab, inliers}, node offsets (len N,))."""
    if len(graphs) < 2:
        raise ValueError("merge_many needs at least two session graphs")
    ms = ms or MultiSessionConfig()
    joint = graphs[0]
    offsets = [0]
    merges = []
    for k, gb in enumerate(graphs[1:], start=1):
        offsets.append(len(joint.poses))
        matches = cross_session_matches(joint, gb, cfg, ms, lc)
        if len(matches) < ms.min_matches:
            raise ValueError(
                f"session {k}: only {len(matches)} verified cross-session "
                f"matches against the joint graph (< {ms.min_matches}); "
                "session does not overlap enough to merge")
        t_ab, inliers = align_from_matches(joint, gb, matches, ms)
        if len(inliers) < ms.min_matches:
            raise ValueError(
                f"session {k}: only {len(inliers)} consensus-consistent "
                f"matches (< {ms.min_matches}); refusing to merge")
        joint = merge_graphs(joint, gb, inliers, t_ab)
        merges.append(dict(session=k, t_ab=t_ab, inliers=inliers))
    graph = joint.to_arrays()
    if mesh is not None:
        from cfear_jax.parallel import pgo
        opt, _ = pgo.distributed_optimize(graph, mesh, iters=iters)
    else:
        opt, _ = posegraph.optimize(graph, iters=iters)
    return (np.asarray(opt.poses)[:len(joint.poses)], joint, merges,
            np.asarray(offsets))


def merge_sessions(gb_a: posegraph.GraphBuilder,
                   gb_b: posegraph.GraphBuilder,
                   cfg: CFEARConfig,
                   ms: MultiSessionConfig | None = None,
                   lc: loopclosure.LoopCloserConfig | None = None,
                   mesh=None, iters: int = 15):
    """Full multi-session pass: match -> align -> merge -> jointly optimize.

    Returns (opt_poses (K_a + K_b, 3), joint GraphBuilder, inlier matches,
    t_ab). With `mesh`, the joint solve runs edge-sharded over the device
    mesh (`parallel/pgo.distributed_optimize`)."""
    ms = ms or MultiSessionConfig()
    matches = cross_session_matches(gb_a, gb_b, cfg, ms, lc)
    if len(matches) < ms.min_matches:
        raise ValueError(
            f"only {len(matches)} verified cross-session matches "
            f"(< {ms.min_matches}); sessions do not overlap enough to merge")
    t_ab, inliers = align_from_matches(gb_a, gb_b, matches, ms)
    # the bar applies to the CONSENSUS inliers, not the raw matches: two
    # verified-but-aliased matches that disagree on T_ab must refuse to
    # merge rather than glue the maps at an arbitrary single-vote
    # transform
    if len(inliers) < ms.min_matches:
        raise ValueError(
            f"only {len(inliers)} consensus-consistent cross-session "
            f"matches (< {ms.min_matches}); sessions do not overlap "
            "enough to merge")
    joint = merge_graphs(gb_a, gb_b, inliers, t_ab)
    graph = joint.to_arrays()
    if mesh is not None:
        from cfear_jax.parallel import pgo
        opt, _ = pgo.distributed_optimize(graph, mesh, iters=iters)
    else:
        opt, _ = posegraph.optimize(graph, iters=iters)
    return np.asarray(opt.poses)[:len(joint.poses)], joint, inliers, t_ab
