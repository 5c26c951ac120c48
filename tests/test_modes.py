"""Tests for ablation/variant modes: raw pointcloud, time-continuous
registration, covariance-by-sampling."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from cfear_jax.config import preset
from cfear_jax.datasets import synthetic
from cfear_jax.models import odometry
from cfear_jax.ops import features, filtering, registration
from cfear_jax.eval.trajectory import ate_rmse


def _cfg(**feat_kw):
    cfg = preset("CFEAR-3", dataset="synthetic")
    feat = dataclasses.replace(cfg.feature, max_cells=256, max_cells_raw=1024,
                               **feat_kw)
    filt = dataclasses.replace(cfg.filter, k_strongest=8)
    return cfg.replace(feature=feat, filter=filt)


def test_raw_pointcloud_mode_runs():
    cfg = _cfg(use_raw_pointcloud=True)
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, cost="P2P"))
    images, gt = synthetic.make_sequence(seed=21, n_frames=10, cfg=cfg)
    runner = odometry.OdometryRunner(cfg, chunk=5)
    runner.process(images)
    traj = runner.trajectory()
    assert np.isfinite(traj).all()
    assert bool(runner.frame_outputs().success.all())
    # raw mode is the ablation: coarser but must still track
    assert ate_rmse(traj[:, :2], gt[:, :2]) < 2.0


def test_raw_cells_identity_semantics():
    cfg = _cfg(use_raw_pointcloud=True)
    rng = np.random.default_rng(0)
    img = synthetic.render_polar(synthetic.make_world(rng), np.zeros(3), cfg,
                                 rng)
    pts = filtering.filter_polar_image(jnp.asarray(img), cfg)
    cells = features.compute_raw_cells(pts, cfg)
    valid = np.asarray(cells.valid)
    assert valid.sum() == min(int(np.asarray(pts.valid).sum()), 1024)
    i = np.where(valid)[0][0]
    np.testing.assert_allclose(np.asarray(cells.cov)[i],
                               0.1 * np.eye(2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(cells.normal)[i], [1, 0], atol=1e-6)
    assert np.asarray(cells.nsamples)[i] == 1.0


def test_time_continuous_register_with_distorted_scan():
    cfg = _cfg()
    rng = np.random.default_rng(3)
    world = synthetic.make_world(rng)
    motion = np.array([1.5, 0.0, 0.03])
    img0 = synthetic.render_polar(world, np.zeros(3), cfg, rng,
                                  noise_scale=0.0)
    img1 = synthetic.render_polar(world, np.array([1.5, 0.0, 0.03]), cfg, rng,
                                  motion=motion, noise_scale=0.0)

    def cells(img):
        return features.compute_cells(
            filtering.filter_polar_image(jnp.asarray(img), cfg), cfg)

    c0, c1 = cells(img0), cells(img1)
    kf = jax.tree.map(lambda a: a[None], c0)
    guess = jnp.asarray([1.4, 0.05, 0.02], jnp.float32)
    plain = registration.register(kf, jnp.zeros((1, 3)), jnp.ones(1, bool),
                                  c1, guess, cfg=cfg)
    cont = registration.register_time_continuous(
        kf, jnp.zeros((1, 3)), jnp.ones(1, bool), c1, guess,
        jnp.asarray(motion, jnp.float32), ccw=False, cfg=cfg)
    err_plain = np.linalg.norm(np.asarray(plain.pose)[:2] - motion[:2])
    err_cont = np.linalg.norm(np.asarray(cont.pose)[:2] - motion[:2])
    assert bool(cont.success)
    # compensating the distortion must not hurt, and usually helps
    assert err_cont <= err_plain + 0.02


def test_time_continuous_pipeline_flag():
    """`registration.time_continuous` wires `register_time_continuous` into
    the per-frame pipeline (config + CLI surface of `RegisterTimeContinuous`,
    `n_scan_normal.cpp:67-80`): the flagged run must track the same
    trajectory class as the default run (the reference reports the variant
    as drift-neutral, `n_scan_normal.cpp:227`)."""
    cfg = _cfg()
    images, gt = synthetic.make_sequence(seed=29, n_frames=16, cfg=cfg,
                                         speed=8.0)

    def run(tc):
        c = cfg.replace(registration=dataclasses.replace(
            cfg.registration, time_continuous=tc))
        runner = odometry.OdometryRunner(c, chunk=8)
        runner.process(images)
        assert bool(runner.frame_outputs().success.all())
        return runner.trajectory()

    t_off, t_on = run(False), run(True)
    assert np.isfinite(t_on).all()
    a_off = ate_rmse(t_off[:, :2], gt[:, :2])
    a_on = ate_rmse(t_on[:, :2], gt[:, :2])
    # both track; the warp changes poses by at most cm-scale here
    assert a_on < max(2.0 * a_off, 0.35)
    assert np.max(np.linalg.norm(t_on[:, :2] - t_off[:, :2], axis=1)) < 1.0


def test_covariance_sampling_convex_case():
    cfg = _cfg()
    cfg = cfg.replace(odometry=dataclasses.replace(
        cfg.odometry, estimate_cov_by_sampling=True))
    images, gt = synthetic.make_sequence(seed=23, n_frames=8, cfg=cfg)
    runner = odometry.OdometryRunner(cfg, chunk=4)
    runner.process(images)
    out = runner.frame_outputs()
    covs = np.asarray(out.cov)[1:]
    assert np.isfinite(covs).all()
    # sampled covariances are SPD when used
    for c in covs:
        assert np.all(np.linalg.eigvalsh(c) > 0)
