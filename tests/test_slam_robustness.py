"""SLAM back-end robustness: robust loop-edge kernels, CANDIDATE masking,
poisoned-graph containment (VERDICT r2 weaknesses #3/#4).

Measured kernel comparison on the 40-node noisy ring (one genuine loop
edge; poisoned variant adds one wildly wrong 50 m loop edge), 15 GN iters:

    kernel       clean ATE   poisoned ATE
    quadratic      0.263        12.52     <- one bad edge folds the map
    Huber(1)       0.264         6.89     <- bounded but nonzero influence
    Cauchy(1)      0.200         0.20     <- redescending: bad edge vanishes
    DCS(4)         1.712         1.71     <- too aggressive, kills true loop

hence the shipped default `DEFAULT_LOOP_LOSS = "Cauchy", limit 1.0`
(whitened units). Odometry edges stay quadratic: they are the trusted
backbone; robustifying them would let the optimizer ignore the chain.
"""

import numpy as np
import jax

from cfear_jax.models import posegraph
from test_posegraph import _noisy_ring_graph


def _ate(poses, gt):
    return float(np.sqrt(np.mean(
        np.sum((np.asarray(poses)[:, :2] - gt[:, :2]) ** 2, -1))))


def _poison(gb):
    """Inject one wildly wrong loop edge (perceptual aliasing survivor)."""
    info = np.eye(3) * np.array([100.0, 100.0, 400.0])
    gb.add_loop_edge(30, 10, np.array([50.0, 20.0, 1.0]),
                     np.linalg.inv(info * 10))
    return gb


def test_poisoned_graph_contained_at_defaults():
    """One false-positive loop edge must NOT fold the trajectory: optimized
    ATE with the poisoned graph stays within 2x the clean-graph ATE (the
    VERDICT r2 acceptance criterion) at the SHIPPED defaults."""
    rng = np.random.default_rng(0)
    gb_clean, gt = _noisy_ring_graph(rng)
    rng = np.random.default_rng(0)
    gb_poison, _ = _noisy_ring_graph(rng)
    _poison(gb_poison)

    opt_c, _ = posegraph.optimize(gb_clean.to_arrays(), iters=15, cg_iters=80)
    opt_p, _ = posegraph.optimize(gb_poison.to_arrays(), iters=15,
                                  cg_iters=80)
    ate_c, ate_p = _ate(opt_c.poses, gt), _ate(opt_p.poses, gt)
    assert ate_p < 2.0 * ate_c, (ate_p, ate_c)
    # and the clean result must not be degraded vs the quadratic kernel
    opt_q, _ = posegraph.optimize(gb_clean.to_arrays(), iters=15,
                                  cg_iters=80, loop_loss="None")
    assert ate_c < 1.5 * _ate(opt_q.poses, gt)


def test_quadratic_kernel_folds_poisoned_graph():
    """Control: WITHOUT the robust kernel the same poisoned graph diverges
    (documents why the default is not quadratic)."""
    rng = np.random.default_rng(0)
    gb, gt = _noisy_ring_graph(rng)
    _poison(gb)
    opt, _ = posegraph.optimize(gb.to_arrays(), iters=15, cg_iters=80,
                                loop_loss="None")
    assert _ate(opt.poses, gt) > 5.0


def test_candidate_edges_never_optimized():
    """CANDIDATE constraints (`types.h:150-190`) are stored-but-unverified:
    they must contribute NOTHING to residuals or the optimum."""
    rng = np.random.default_rng(0)
    gb, gt = _noisy_ring_graph(rng)
    # a catastrophically wrong edge, but staged as CANDIDATE
    info = np.eye(3) * np.array([100.0, 100.0, 400.0])
    gb.add_loop_edge(30, 10, np.array([50.0, 20.0, 1.0]),
                     np.linalg.inv(info * 10), kind=posegraph.CANDIDATE,
                     quality={"score": 0.5})
    graph = gb.to_arrays()
    r = posegraph.edge_residuals(graph.poses, graph)
    cand = np.asarray(graph.edge_type) == posegraph.CANDIDATE
    assert cand.sum() == 1
    np.testing.assert_array_equal(np.asarray(r)[cand], 0.0)

    # exact semantic check: the GN gradient (J^T r) with the candidate edge
    # present equals the gradient without it (single evaluation — no CG
    # chaos in the comparison)
    import jax as _jax
    rng = np.random.default_rng(0)
    gb_ref, _ = _noisy_ring_graph(rng)
    graph_ref = gb_ref.to_arrays()

    def grad_of(g):
        r, vjp = _jax.vjp(lambda p: posegraph.edge_residuals(p, g), g.poses)
        return np.asarray(vjp(r)[0])

    np.testing.assert_allclose(grad_of(graph), grad_of(graph_ref),
                               atol=1e-5)
    # end-to-end: optimized ATE identical at measurement level (fixed-count
    # f32 CG beyond convergence amplifies reduction-order noise pose-wise,
    # so the comparison is on the metric, not element-wise poses)
    opt_a, _ = posegraph.optimize(graph, iters=10, cg_iters=60)
    opt_b, _ = posegraph.optimize(graph_ref, iters=10, cg_iters=60)
    assert abs(_ate(opt_a.poses, gt) - _ate(opt_b.poses, gt)) < 0.02


def test_distributed_optimizer_matches_robust_semantics():
    """The edge-sharded optimizer must apply the same robust kernel: its
    poisoned-graph result matches the single-device optimizer."""
    from cfear_jax.parallel.mesh import make_mesh
    from cfear_jax.parallel.pgo import (
        distributed_optimize)

    rng = np.random.default_rng(0)
    gb, gt = _noisy_ring_graph(rng)
    _poison(gb)
    graph = gb.to_arrays()
    mesh = make_mesh(len(jax.devices()))
    opt_d, _ = distributed_optimize(graph, mesh, iters=10, cg_iters=60)
    opt_s, _ = posegraph.optimize(graph, iters=10, cg_iters=60)
    # psum reduction order differs from the single-device sum; the ATE
    # agreement (not element-wise poses after 600 f32 CG steps) is the
    # robust-semantics signal: without the kernel the poisoned ATE is ~12
    ate_d, ate_s = _ate(opt_d.poses, gt), _ate(opt_s.poses, gt)
    assert abs(ate_d - ate_s) < 0.05, (ate_d, ate_s)
    assert ate_d < 1.0


def test_quality_map_roundtrip(tmp_path):
    """`Constraint3d::quality` map semantics: stored per edge, survives
    save/load (`types.h:176-190`)."""
    rng = np.random.default_rng(2)
    gb, _ = _noisy_ring_graph(rng)
    gb.add_loop_edge(39, 0, np.zeros(3), np.eye(3) * 0.01,
                     quality={"score": 0.031, "num_assoc": 211})
    gb.add_loop_edge(20, 5, np.zeros(3), np.eye(3) * 0.01,
                     kind=posegraph.CANDIDATE,
                     quality={"score": 0.4, "num_assoc": 17})
    path = str(tmp_path / "g.npz")
    gb.save(path)
    gb2 = posegraph.GraphBuilder.load(path)
    assert len(gb2.quality) == 2
    pos = gb2._index[(posegraph.CANDIDATE, (5, 20))]
    assert gb2.quality[pos]["score"] == 0.4
    pos = gb2._index[(posegraph.LOOP_APPEARANCE, (0, 39))]
    assert gb2.quality[pos]["num_assoc"] == 211
