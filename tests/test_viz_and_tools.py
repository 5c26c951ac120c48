import os

import numpy as np
import jax
import jax.numpy as jnp

from cfear_jax import eval_trajectories, radar_filter
from cfear_jax.eval import viz


def test_radar_filter_cli(tmp_path):
    out = str(tmp_path / "f.npz")
    plot = str(tmp_path / "f.png")
    radar_filter.main(["--cpu", "--n-frames", "2", "--output", out,
                       "--plot", plot])
    z = np.load(out)
    assert "xy_0" in z and len(z["xy_0"]) > 50
    assert z["peaks_0"].sum() > 0
    assert os.path.getsize(plot) > 1000


def test_eval_cli(tmp_path):
    from cfear_jax.eval import trajectory
    # fabricate a run directory
    t = np.linspace(0, 2 * np.pi, 300)
    gt = np.stack([100 * np.cos(t), 100 * np.sin(t), t + np.pi / 2], -1)
    est = gt.copy()
    est[:, :2] *= 1.01
    d = tmp_path / "run"
    trajectory.save_trajectories(str(d), "00", t, est, gt_xyt=gt)
    out = str(tmp_path / "res.txt")
    eval_trajectories.main(["--est", str(d), "--output", out,
                            "--plot", str(tmp_path / "t.png")])
    text = open(out).read()
    assert "t_err_percent" in text
    val = float(text.split("t_err_percent: ")[1].split("\n")[0])
    assert 0.3 < val < 3.0


def test_cost_surface_real():
    import dataclasses
    from cfear_jax.config import preset
    from cfear_jax.datasets import synthetic
    from cfear_jax.ops import (features, filtering,
                                                         registration)
    cfg = preset("CFEAR-3", dataset="synthetic")
    cfg = cfg.replace(feature=dataclasses.replace(cfg.feature, max_cells=256),
                      filter=dataclasses.replace(cfg.filter, k_strongest=8))
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng)
    img = synthetic.render_polar(world, np.zeros(3), cfg, rng)
    cells = features.compute_cells(
        filtering.filter_polar_image(jnp.asarray(img), cfg), cfg)
    kf = jax.tree.map(lambda a: a[None], cells)
    surf, extent = registration.cost_surface(
        kf, jnp.zeros((1, 3)), jnp.ones(1, bool), cells,
        jnp.zeros(3, jnp.float32), cfg, width=2.0, res=0.5)
    surf = np.asarray(surf)
    assert surf.shape == (9, 9)
    # minimum at the center (identity is the optimum for self-registration)
    assert surf[4, 4] == surf.min()


def test_live_viz_follows_growing_tum(tmp_path):
    """The live viewer (the RViz path/odom-marker equivalent for a
    headless environment) must pick up newly appended TUM poses across
    polls and re-render its PNG atomically."""
    import math

    import numpy as np

    from cfear_jax.eval import live_viz

    tum = tmp_path / "poses.tum"

    def line(t, x, y, yaw):
        return (f"{t:.6f} {x:.6f} {y:.6f} 0.000000 0.000000 0.000000 "
                f"{math.sin(yaw / 2):.6f} {math.cos(yaw / 2):.6f}\n")

    with open(tum, "w") as f:
        for i in range(5):
            f.write(line(i * 0.25, i * 1.5, 0.2 * i, 0.01 * i))
    out = str(tmp_path / "live.png")
    res = live_viz.main(["--poses", str(tum), "--out", out])
    assert res["n_poses"] == 5 and os.path.exists(out)
    size1 = os.path.getsize(out)

    # grow the file, incl. a partial trailing line that must be ignored
    fol = live_viz.TumFollower(str(tum))
    assert fol.poll() == 5
    with open(tum, "a") as f:
        for i in range(5, 9):
            f.write(line(i * 0.25, i * 1.5, 0.2 * i, 0.01 * i))
        f.write("1.0 2.0 3.0")      # incomplete record
    assert fol.poll() == 4
    assert len(fol.poses) == 9
    live_viz.render_snapshot(out, fol.poses)
    assert os.path.getsize(out) > 0 and size1 > 0
    # parse round-trip
    t, x, y, yaw = fol.poses[-1]
    assert abs(x - 8 * 1.5) < 1e-6 and abs(yaw - 0.08) < 1e-6
