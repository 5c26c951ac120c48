"""Golden end-to-end test through the REAL Oxford dataset-loader path.

VERDICT r2 missing #5: no committed test pinned a full-sensor-scale
(400 x (11+3768)) image -> result.txt value through the actual
`--dataset oxford` loader; prior e2e goldens used the synthetic loader.
Here a 5+-frame Oxford-format directory is fabricated from the simulator:

- one PNG per sweep named <unix_microseconds>.png, 400 rows x (11 + 3768)
  columns, the first 11 columns being metadata the loader must strip
  (`datasets/oxford.py:41-52`, reference `radar_driver.cpp:99-111`);
- `radar_odometry.csv` in the released Oxford relative-pose format
  (source/destination timestamps + x y z roll pitch yaw rows,
  `offline_odometry.cpp:80-97` integration semantics).

The full CLI (`offline_odometry.main`) then runs loader -> pipeline ->
evaluator and the result.txt ATE is pinned.
"""

import os

import numpy as np
import pytest

from cfear_jax import offline_odometry
from cfear_jax.config import preset
from cfear_jax.datasets import synthetic
from cfear_jax.utils import se2

N_FRAMES = 12
T0_US = 1_547_120_000_000_000          # arbitrary Oxford-era epoch stamp


def _write_oxford_fixture(root):
    """Render Oxford-scale sweeps and write them in the released layout."""
    from PIL import Image
    import jax.numpy as jnp

    cfg = preset("CFEAR-3", dataset="oxford")
    rng = np.random.default_rng(7)
    world = synthetic.make_world(rng)
    dt = cfg.radar.sensor_period
    # N_FRAMES + 1 poses: pose 0 is a virtual pre-roll pose so the FIRST
    # image stamp is interior to the GT bracket (the loader's
    # `interpolate_gt` — like the reference's One2OneCorrespondance —
    # drops est stamps at the GT boundary)
    traj = synthetic.make_trajectory(np.random.default_rng(8), N_FRAMES + 1,
                                     dt=dt, speed=8.0)
    gt = traj[1:]                                 # poses of the images
    radar_dir = os.path.join(root, "radar")
    os.makedirs(radar_dir, exist_ok=True)
    stamps_us = [T0_US + int(i * dt * 1e6) for i in range(N_FRAMES + 1)]
    for i in range(N_FRAMES):
        k = i + 1                                 # trajectory index
        prev, cur = traj[k - 1], traj[k]
        c, s = np.cos(prev[2]), np.sin(prev[2])
        dx, dy = cur[0] - prev[0], cur[1] - prev[1]
        motion = np.array([c * dx + s * dy, -s * dx + c * dy,
                           cur[2] - prev[2]])
        img = synthetic.render_polar(world, traj[k], cfg,
                                     np.random.default_rng(1000 + i),
                                     motion=motion, t=k * dt)
        assert img.shape == (400, 3768)
        meta = np.zeros((400, 11), np.uint8)          # stripped by loader
        full = np.concatenate([meta, img], axis=1)
        Image.fromarray(full).save(
            os.path.join(radar_dir, f"{stamps_us[k]}.png"))

    # Oxford gt/radar_odometry.csv: relative pose destination->source rows
    csv = os.path.join(root, "radar_odometry.csv")
    with open(csv, "w") as f:
        f.write("source_radar_timestamp,destination_radar_timestamp,"
                "x,y,z,roll,pitch,yaw\n")
        for i in range(N_FRAMES):
            rel = np.asarray(se2.relative(jnp.asarray(traj[i]),
                                          jnp.asarray(traj[i + 1])))
            f.write(f"{stamps_us[i]},{stamps_us[i + 1]},"
                    f"{rel[0]:.9f},{rel[1]:.9f},0.0,0.0,0.0,{rel[2]:.9f}\n")
    return radar_dir, csv, gt


@pytest.mark.slow
def test_oxford_loader_to_result_txt_golden(tmp_path):
    radar_dir, gt_csv, gt = _write_oxford_fixture(str(tmp_path))
    out_dir = str(tmp_path / "run")
    result = offline_odometry.main([
        "--dataset", "oxford", "--radar-dir", radar_dir,
        "--gt-csv", gt_csv, "--output-dir", out_dir,
        "--preset", "CFEAR-3", "--chunk", "4", "--cpu"])

    # the loader path delivered every frame at full sensor scale
    assert result["frames"] == N_FRAMES
    assert result["registration_failures"] == 0
    # GOLDEN: ATE of the real-loader end-to-end chain. Pinned from the
    # r3 run (0.060 m over a 22 m trajectory); the bound is 3x to absorb
    # cross-platform ulp -> solver-iteration differences while still
    # catching any loader regression (wrong column strip, stamp parse,
    # GT integration), each of which shifts ATE by meters.
    assert result["ate_m"] < 0.18, result
    # artifacts exist with content
    assert os.path.exists(os.path.join(out_dir, "est", "result.txt"))
    assert os.path.exists(os.path.join(out_dir, "pars.txt"))
    kitti = os.path.join(out_dir, "est", "00.txt")
    assert os.path.exists(kitti)
    rows = np.loadtxt(kitti).reshape(-1, 12)
    assert rows.shape[0] == N_FRAMES

    # the estimated end pose must track GT end-to-end (<2% of path length);
    # est poses are relative to the first image's frame -> rebase GT there
    import jax.numpy as jnp
    path_len = np.sum(np.linalg.norm(np.diff(gt[:, :2], axis=0), axis=1))
    est_end = rows[-1, [3, 7]]
    end_rel = np.asarray(se2.relative(jnp.asarray(gt[0]),
                                      jnp.asarray(gt[-1])))
    assert np.linalg.norm(est_end - end_rel[:2]) < 0.02 * path_len
