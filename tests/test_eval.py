import os

import numpy as np

from cfear_jax.eval import kitti, trajectory


def _circle_traj(n=400, radius=100.0):
    th = np.linspace(0, 1.5 * np.pi, n)
    xy = np.stack([radius * np.cos(th), radius * np.sin(th)], -1)
    yaw = th + np.pi / 2
    return np.concatenate([xy, yaw[:, None]], -1)


def test_drift_zero_for_identical():
    gt = _circle_traj()
    res = kitti.kitti_drift(gt, gt)
    assert res["n_subsequences"] > 0
    assert res["t_err_percent"] < 1e-9
    assert res["r_err_deg_per_m"] < 1e-9


def test_drift_detects_scale_error():
    gt = _circle_traj()
    est = gt.copy()
    est[:, :2] *= 1.01                      # 1% scale error -> ~1% drift
    res = kitti.kitti_drift(est, gt, lengths=(100.0, 200.0))
    assert 0.5 < res["t_err_percent"] < 2.0


def test_drift_detects_rotation_bias():
    gt = _circle_traj()
    est = gt.copy()
    est[:, 2] += np.linspace(0, 0.1, len(gt))   # growing yaw bias
    res = kitti.kitti_drift(est, gt, lengths=(100.0,))
    assert res["r_err_deg_per_m"] > 1e-4


def test_kitti_writer_roundtrip(tmp_path):
    poses = _circle_traj(50)
    mats = trajectory.poses_to_matrices(poses)
    p = os.path.join(tmp_path, "est.txt")
    trajectory.write_kitti(p, mats)
    with open(p) as f:
        first = f.readline().split()
    assert len(first) == 12                  # 3x4 row-major
    back = trajectory.read_kitti(p)
    np.testing.assert_allclose(back[:, :3, :4], mats[:, :3, :4], atol=1e-5)


def test_tum_writer_format(tmp_path):
    poses = _circle_traj(5)
    stamps = [1547120000.25 + i * 0.25 for i in range(5)]
    p = os.path.join(tmp_path, "est_tum.txt")
    trajectory.write_tum(p, stamps, poses)
    lines = open(p).read().strip().split("\n")
    assert len(lines) == 5
    parts = lines[0].split()
    assert len(parts) == 8                   # t x y z qx qy qz qw
    assert "." in parts[0] and len(parts[0].split(".")[1]) == 9


def test_interpolate_gt():
    gt_stamps = np.arange(0.0, 10.0, 1.0)
    gt_poses = np.stack([gt_stamps, gt_stamps * 2,
                         np.linspace(0, 0.9, 10)], -1)
    est_stamps = np.array([-0.5, 0.5, 2.25, 9.5])
    keep, interp = trajectory.interpolate_gt(est_stamps, gt_stamps, gt_poses)
    np.testing.assert_array_equal(keep, [1, 2])   # outside range dropped
    np.testing.assert_allclose(interp[0], [0.5, 1.0, 0.05], atol=1e-9)
    np.testing.assert_allclose(interp[1], [2.25, 4.5, 0.225], atol=1e-9)


def test_umeyama_alignment():
    rng = np.random.default_rng(0)
    gt = rng.uniform(-50, 50, (100, 2))
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    est = (gt - np.array([3.0, 4.0])) @ R.T
    ate = trajectory.ate_rmse(est, gt, align=True)
    assert ate < 1e-6
    assert trajectory.ate_rmse(est, gt, align=False) > 1.0


def test_save_trajectories(tmp_path):
    poses = _circle_traj(10)
    stamps = np.arange(10) * 0.25
    covs = np.tile(np.eye(3)[None], (10, 1, 1))
    trajectory.save_trajectories(str(tmp_path), "01", stamps, poses,
                                 covs=covs, gt_xyt=poses)
    assert os.path.exists(tmp_path / "est" / "01.txt")
    assert os.path.exists(tmp_path / "est" / "01_tum.txt")
    assert os.path.exists(tmp_path / "est" / "01_cov.txt")
    assert os.path.exists(tmp_path / "gt" / "01.txt")
