import os

import numpy as np

from cfear_jax import offline_odometry
from cfear_jax.parallel import sweep


BASE = ["--dataset", "synthetic", "--n-frames", "8", "--cpu",
        "--max_cells", "256", "--k_strongest", "8", "--chunk", "8"]


def test_offline_odometry_cli(tmp_path):
    out = str(tmp_path / "run")
    res = offline_odometry.main(BASE + ["--output-dir", out])
    assert res["frames"] == 8
    assert res["registration_failures"] == 0
    for f in ["est/00.txt", "est/00_tum.txt", "est/00_cov.txt",
              "est/result.txt", "gt/00.txt", "pars.txt",
              "simple_graph.npz"]:
        assert os.path.exists(os.path.join(out, f)), f
    kitti = np.loadtxt(os.path.join(out, "est", "00.txt"))
    assert kitti.shape == (8, 12)


def test_cli_overrides(tmp_path):
    out = str(tmp_path / "run2")
    offline_odometry.main(BASE + ["--output-dir", out, "--cost_type", "P2L",
                                  "--loss_type", "Cauchy",
                                  "--submap_scan_size", "2"])
    pars = open(os.path.join(out, "pars.txt")).read()
    assert "registration.cost, P2L" in pars
    assert "registration.loss, Cauchy" in pars
    assert "odometry.submap_scan_size, 2" in pars


def test_sweep_and_merge(tmp_path):
    root = str(tmp_path / "sweep")
    grid = {"cost_type": ["P2L", "P2P"]}
    dirs = sweep.run_sweep(root, grid, BASE)
    assert len(dirs) == 2
    n = sweep.merge(root, os.path.join(root, "merged.csv"))
    assert n == 2
    text = open(os.path.join(root, "merged.csv")).read()
    assert "P2L" in text and "P2P" in text and "ate_m" in text


def test_checkpoint_resume(tmp_path):
    import dataclasses
    import jax.numpy as jnp
    from cfear_jax.config import preset
    from cfear_jax.datasets import synthetic
    from cfear_jax.models import odometry

    cfg = preset("CFEAR-3", dataset="synthetic")
    cfg = cfg.replace(feature=dataclasses.replace(cfg.feature, max_cells=256),
                      filter=dataclasses.replace(cfg.filter, k_strongest=8))
    images, _ = synthetic.make_sequence(seed=2, n_frames=12, cfg=cfg)

    full = odometry.OdometryRunner(cfg, chunk=6)
    full.process(images)
    ref = full.trajectory()

    part = odometry.OdometryRunner(cfg, chunk=6)
    part.process(images[:6])
    ckpt = str(tmp_path / "ckpt.npz")
    part.save_checkpoint(ckpt)

    resumed = odometry.OdometryRunner.resume(cfg, ckpt, chunk=6)
    resumed.process(images[6:])
    np.testing.assert_allclose(resumed.trajectory(), ref, atol=1e-5)


def test_scaling_efficiency_tool():
    """tools/scaling_efficiency.py: 2 pinned workers, one JSON line."""
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "scaling_efficiency.py"),
         "--n-frames", "8"],
        capture_output=True, text=True, env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metric"] == "scaling_efficiency_2worker_proxy"
    if res["value"] is not None:          # >=2 cores available
        assert 0.2 < res["value"] <= 1.5, res


def test_config_file_roundtrip(tmp_path):
    """YAML/JSON config round-trip + --config-file as the CLI base."""
    from cfear_jax.config import CFEARConfig, preset

    cfg = preset("CFEAR-2", dataset="mulran")
    for ext in ("yaml", "json"):
        p = str(tmp_path / f"cfg.{ext}")
        cfg.save(p)
        back = CFEARConfig.load(p)
        assert back == cfg, ext
    p = str(tmp_path / "cfg.yaml")
    out = str(tmp_path / "run3")
    offline_odometry.main(
        ["--dataset", "synthetic", "--n-frames", "6", "--cpu", "--chunk", "6",
         "--config-file", p, "--max_cells", "256", "--k_strongest", "8",
         "--no-save-graph", "--output-dir", out])
    pars = open(os.path.join(out, "pars.txt")).read()
    # base comes from the file (CFEAR-2: submap 3), override applies on top
    assert "odometry.submap_scan_size, 3" in pars
    assert "filter.k_strongest, 8" in pars
