"""Multi-session SLAM: two sessions over ONE world merge into one frame.

VERDICT r3 missing #2 / SURVEY §7 step 8: cross-session loop detection
(ring-key matching between two graphs' scan payloads) + joint optimization
with inter-session LOOP_APPEARANCE edges. Session B drives a stretch of
session A's route (same world, different sensor noise, its own odometry
frame, started mid-route), so the merged estimate must place B's keyframes
at their world positions — while a naive identity alignment is off by the
whole route offset.
"""

import dataclasses

import numpy as np
import pytest

from cfear_jax.config import preset
from cfear_jax.datasets import synthetic
from cfear_jax.models import (multisession,
                                                        odometry, posegraph)

N_A, B_LO, B_HI = 48, 16, 44


def _cfg():
    cfg = preset("CFEAR-3", dataset="synthetic")
    return cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=256),
        filter=dataclasses.replace(cfg.filter, k_strongest=8))


def _render_route(world, route, cfg, seed):
    imgs = []
    for i in range(len(route)):
        prev = route[i - 1] if i > 0 else route[i]
        c, s = np.cos(prev[2]), np.sin(prev[2])
        dx, dy = route[i, 0] - prev[0], route[i, 1] - prev[1]
        motion = np.array([c * dx + s * dy, -s * dx + c * dy,
                           route[i, 2] - prev[2]])
        imgs.append(synthetic.render_polar(
            world, route[i], cfg, np.random.default_rng(seed + i),
            motion=motion))
    return np.stack(imgs)


def _run_session(images, cfg):
    runner = odometry.OdometryRunner(cfg, chunk=8)
    runner.process(images)
    out = runner.frame_outputs()
    traj = np.asarray(runner.trajectory())
    gb = posegraph.build_graph_from_odometry(out, traj, images=images,
                                             cfg=cfg)
    return gb, traj, np.where(np.asarray(out.fused))[0]


@pytest.fixture(scope="module")
def sessions():
    cfg = _cfg()
    rng = np.random.default_rng(42)
    world = synthetic.make_world(rng)
    traj_a = synthetic.make_trajectory(np.random.default_rng(43), N_A,
                                       dt=cfg.radar.sensor_period, speed=8.0)
    route_b = traj_a[B_LO:B_HI]         # same route, revisited
    imgs_a = _render_route(world, traj_a, cfg, seed=100)
    imgs_b = _render_route(world, route_b, cfg, seed=900)  # fresh speckle
    gb_a, traj_est_a, kf_a = _run_session(imgs_a, cfg)
    gb_b, traj_est_b, kf_b = _run_session(imgs_b, cfg)
    return dict(cfg=cfg, traj_a=traj_a, route_b=route_b, world=world,
                gb_a=gb_a, gb_b=gb_b, kf_a=kf_a, kf_b=kf_b)


@pytest.fixture(scope="module")
def session_c(sessions):
    """A THIRD session over the same world (another stretch of A's route,
    fresh speckle) for the N-session incremental merge tests."""
    cfg = sessions["cfg"]
    route_c = sessions["traj_a"][8:36]
    imgs_c = _render_route(sessions["world"], route_c, cfg, seed=1700)
    gb_c, _, kf_c = _run_session(imgs_c, cfg)
    return dict(route_c=route_c, gb_c=gb_c, kf_c=kf_c)


def test_cross_session_matching_and_alignment(sessions):
    cfg = sessions["cfg"]
    matches = multisession.cross_session_matches(
        sessions["gb_a"], sessions["gb_b"], cfg)
    assert len(matches) >= 2, "revisited route must produce verified matches"
    t_ab, inliers = multisession.align_from_matches(
        sessions["gb_a"], sessions["gb_b"], matches)
    assert len(inliers) >= 2
    # true alignment: B's odometry frame sits at world pose route_b[0]
    # (session A's frame IS the world frame up to A's drift at these
    # path lengths — sub-decimetre)
    t_true = sessions["route_b"][0]
    assert np.linalg.norm(t_ab[:2] - t_true[:2]) < 1.0, (t_ab, t_true)
    assert abs(np.angle(np.exp(1j * (t_ab[2] - t_true[2])))) < 0.06


def test_merge_sessions_joint_optimization(sessions):
    cfg = sessions["cfg"]
    gb_a, gb_b = sessions["gb_a"], sessions["gb_b"]
    ka = len(gb_a.poses)
    opt, joint, inliers, t_ab = multisession.merge_sessions(
        gb_a, gb_b, cfg)
    assert len(joint.poses) == ka + len(gb_b.poses)
    # inter-session edges present and typed LOOP_APPEARANCE
    cross = [e for e in joint.edges
             if e[4] == posegraph.LOOP_APPEARANCE
             and (e[0] < ka) != (e[1] < ka)]
    assert len(cross) == len(inliers) >= 2
    # both sessions' odometry chains survived the merge
    assert joint.n_constraints(posegraph.ODOMETRY) == \
        gb_a.n_constraints(posegraph.ODOMETRY) \
        + gb_b.n_constraints(posegraph.ODOMETRY)

    # cross-session accuracy: B's optimized keyframes vs their WORLD
    # positions (A's frame = world frame up to A's drift)
    gt_b = sessions["route_b"][sessions["kf_b"]]
    err_merged = np.sqrt(np.mean(np.sum(
        (opt[ka:, :2] - gt_b[:, :2]) ** 2, axis=1)))
    # odometry-only (identity) alignment is off by the route offset
    naive = np.stack(gb_b.poses)[:, :2]
    err_naive = np.sqrt(np.mean(np.sum((naive - gt_b[:, :2]) ** 2, axis=1)))
    assert err_merged < 1.5, err_merged
    assert err_merged < 0.2 * err_naive, (err_merged, err_naive)
    # session A's nodes must not be dragged off by the merge
    gt_a = sessions["traj_a"][sessions["kf_a"]]
    err_a = np.sqrt(np.mean(np.sum((opt[:ka, :2] - gt_a[:, :2]) ** 2,
                                   axis=1)))
    assert err_a < 1.0, err_a


def test_merge_sessions_distributed_mesh(sessions):
    """The joint merged-graph solve runs edge-sharded over a device mesh
    (the multi-chip path dryrun_multichip exercises)."""
    import jax
    from jax.sharding import Mesh
    cfg = sessions["cfg"]
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs the 8-virtual-device CPU mesh")
    mesh = Mesh(np.array(devs), ("data",))
    opt_m, joint, _, _ = multisession.merge_sessions(
        sessions["gb_a"], sessions["gb_b"], cfg, mesh=mesh)
    opt_s, _, _, _ = multisession.merge_sessions(
        sessions["gb_a"], sessions["gb_b"], cfg)
    np.testing.assert_allclose(opt_m, opt_s, atol=5e-2)


def test_merge_rejects_disjoint_sessions():
    """Sessions over DIFFERENT worlds must refuse to merge (no verified
    overlap), not silently glue unrelated maps."""
    cfg = _cfg()
    graphs = []
    for seed in (3, 4):
        images, _ = synthetic.make_sequence(seed=seed, n_frames=12, cfg=cfg,
                                            speed=8.0)
        gb, _, _ = _run_session(images, cfg)
        graphs.append(gb)
    with pytest.raises(ValueError, match="do not overlap"):
        multisession.merge_sessions(graphs[0], graphs[1], cfg)


def test_merge_many_three_sessions(sessions, session_c):
    """VERDICT r4 missing #2: N-session merging. Session C (a third
    traversal of the same world) merges against the ALREADY-MERGED A+B
    joint graph, and its optimized keyframes land at their world positions
    with cross-session error comparable to the pairwise merge."""
    cfg = sessions["cfg"]
    gb_a, gb_b = sessions["gb_a"], sessions["gb_b"]
    gb_c = session_c["gb_c"]
    opt, joint, merges, offsets = multisession.merge_many(
        [gb_a, gb_b, gb_c], cfg)
    ka, kb, kc = len(gb_a.poses), len(gb_b.poses), len(gb_c.poses)
    assert len(joint.poses) == ka + kb + kc
    assert list(offsets) == [0, ka, ka + kb]
    assert [m["session"] for m in merges] == [1, 2]
    # C's matches may close against A's OR B's nodes — both live in the
    # joint graph it was matched against
    assert len(merges[1]["inliers"]) >= 2
    # all three odometry chains survive
    assert joint.n_constraints(posegraph.ODOMETRY) == \
        sum(g.n_constraints(posegraph.ODOMETRY) for g in (gb_a, gb_b, gb_c))

    # cross-session accuracy for BOTH later sessions vs world positions
    gt_b = sessions["route_b"][sessions["kf_b"]]
    err_b = np.sqrt(np.mean(np.sum(
        (opt[ka:ka + kb, :2] - gt_b[:, :2]) ** 2, axis=1)))
    gt_c = session_c["route_c"][session_c["kf_c"]]
    err_c = np.sqrt(np.mean(np.sum(
        (opt[ka + kb:, :2] - gt_c[:, :2]) ** 2, axis=1)))
    assert err_b < 1.5, err_b
    assert err_c < 1.5, err_c
    # chained-merge consistency: the 3-way merge must not degrade the B
    # placement vs the plain pairwise A+B result
    opt2, _, _, _ = multisession.merge_sessions(gb_a, gb_b, cfg)
    err_b_pair = np.sqrt(np.mean(np.sum(
        (opt2[ka:, :2] - gt_b[:, :2]) ** 2, axis=1)))
    assert err_b < max(2.0 * err_b_pair, 1.0), (err_b, err_b_pair)


def test_merge_many_refuses_disjoint_third(sessions):
    """A third session over a DIFFERENT world must refuse to merge into
    the A+B joint graph (named by session index), not glue unrelated maps."""
    cfg = sessions["cfg"]
    images, _ = synthetic.make_sequence(seed=5, n_frames=12, cfg=cfg,
                                        speed=8.0)
    gb_x, _, _ = _run_session(images, cfg)
    with pytest.raises(ValueError, match="session 2"):
        multisession.merge_many(
            [sessions["gb_a"], sessions["gb_b"], gb_x], cfg)


def test_merge_many_cli_three_graphs(sessions, session_c, tmp_path):
    """The merge CLI accepts N graphs and reports per-session merges."""
    from cfear_jax import merge_sessions as cli
    paths = []
    for name, gb in (("a", sessions["gb_a"]), ("b", sessions["gb_b"]),
                     ("c", session_c["gb_c"])):
        p = str(tmp_path / f"{name}.npz")
        gb.save(p)
        paths.append(p)
    out = str(tmp_path / "merged3.npz")
    res = cli.main(paths + ["--out", out, "--cpu"])
    n_total = sum(len(g.poses) for g in (sessions["gb_a"], sessions["gb_b"],
                                         session_c["gb_c"]))
    assert res["n_sessions"] == 3
    assert res["n_nodes"] == n_total
    assert res["n_cross"] >= 4
    merged = posegraph.GraphBuilder.load(out)
    assert len(merged.poses) == n_total


def test_merge_sessions_cli(sessions, tmp_path):
    """The merge CLI consumes two saved simple_graph.npz artifacts (the
    reference's .sgh hand-off form) and writes a merged, optimized graph
    + TUM trajectory."""
    from cfear_jax import merge_sessions as cli
    pa = str(tmp_path / "a.npz")
    pb = str(tmp_path / "b.npz")
    sessions["gb_a"].save(pa)
    sessions["gb_b"].save(pb)
    out = str(tmp_path / "merged.npz")
    tum = str(tmp_path / "merged.tum")
    res = cli.main([pa, pb, "--out", out, "--tum", tum, "--cpu"])
    ka = len(sessions["gb_a"].poses)
    kb = len(sessions["gb_b"].poses)
    assert res["n_nodes"] == ka + kb
    assert res["n_cross"] >= 2
    merged = posegraph.GraphBuilder.load(out)
    assert len(merged.poses) == ka + kb
    cross = [e for e in merged.edges
             if e[4] == posegraph.LOOP_APPEARANCE
             and (e[0] < ka) != (e[1] < ka)]
    assert len(cross) == res["n_cross"]
    rows = np.loadtxt(tum)
    assert rows.shape == (ka + kb, 8)


def test_cross_session_yaw_seed_convention():
    """Cross-session matching must find loops when session B revisits the
    route with a LARGE heading difference — the regime that exposes the
    yaw-seed sign (a negated seed points ~2*yaw away and verification
    rejects everything; same-direction revisits cannot catch it)."""
    cfg = _cfg()
    rng = np.random.default_rng(77)
    world = synthetic.make_world(rng)
    traj_a = synthetic.make_trajectory(np.random.default_rng(78), 24,
                                       dt=cfg.radar.sensor_period, speed=8.0)
    # session B traverses the SAME stretch with headings rotated 90
    # degrees (a crossing-direction revisit). A negated yaw seed points
    # ~180 degrees from the truth here (+-pi/2 vs -pi/2); the
    # reverse-driving case (relative yaw ~ pi) is sign-DEGENERATE and
    # cannot catch the convention
    route_b = traj_a[20:4:-1].copy()
    route_b[:, 2] += np.pi / 2
    imgs_a = _render_route(world, traj_a, cfg, seed=500)
    imgs_b = _render_route(world, route_b, cfg, seed=700)
    gb_a, _, _ = _run_session(imgs_a, cfg)
    gb_b, _, kf_b = _run_session(imgs_b, cfg)
    matches = multisession.cross_session_matches(gb_a, gb_b, cfg)
    assert len(matches) >= 2, \
        "reverse-direction revisit must still produce verified matches"
    t_ab, inliers = multisession.align_from_matches(gb_a, gb_b, matches)
    t_true = route_b[0]
    assert np.linalg.norm(t_ab[:2] - t_true[:2]) < 1.5, (t_ab, t_true)
    assert abs(np.angle(np.exp(1j * (t_ab[2] - t_true[2])))) < 0.1
