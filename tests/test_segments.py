import dataclasses

import numpy as np

from cfear_jax.config import preset
from cfear_jax.datasets import synthetic
from cfear_jax.eval.trajectory import ate_rmse
from cfear_jax.models import odometry
from cfear_jax.parallel import segments


def _cfg():
    cfg = preset("CFEAR-3", dataset="synthetic")
    return cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=256),
        filter=dataclasses.replace(cfg.filter, k_strongest=8))


def test_split_indices_cover_with_overlap():
    w = segments.split_indices(100, 4, 10)
    assert w[0][0] == 0 and w[-1][1] == 100
    for (s0, e0), (s1, e1) in zip(w, w[1:]):
        assert s1 == e0 - 10        # exact overlap
    # single segment passthrough
    assert segments.split_indices(50, 1, 10) == [(0, 50)]


def test_segmented_matches_serial():
    cfg = _cfg()
    images, gt = synthetic.make_sequence(seed=41, n_frames=48, cfg=cfg,
                                         speed=6.0)
    serial = odometry.OdometryRunner(cfg, chunk=8)
    serial.process(images)
    t_serial = serial.trajectory()

    t_seg = segments.run_segmented(images, cfg, n_segments=3, overlap=8,
                                   chunk=8)
    assert t_seg.shape == t_serial.shape
    ate_serial = ate_rmse(t_serial[:, :2], gt[:, :2])
    ate_seg = ate_rmse(t_seg[:, :2], gt[:, :2])
    # segment seams must stay within odometry noise
    assert ate_seg < ate_serial + 0.3, (ate_seg, ate_serial)
    # stitched trajectory is continuous (no seam jumps)
    step = np.linalg.norm(np.diff(t_seg[:, :2], axis=0), axis=1)
    assert step.max() < 3.0


def test_segmented_on_mesh():
    import jax
    from cfear_jax.parallel.mesh import make_mesh
    cfg = _cfg()
    images, gt = synthetic.make_sequence(seed=43, n_frames=32, cfg=cfg)
    mesh = make_mesh(4)
    t_seg = segments.run_segmented(images, cfg, n_segments=4, overlap=6,
                                   chunk=8, mesh=mesh)
    assert np.isfinite(t_seg).all()
    assert ate_rmse(t_seg[:, :2], gt[:, :2]) < 1.0
