"""Long-run drift artifact at current defaults + mid-run checkpoint/resume.

No committed number used the full KITTI 100-800 m protocol before this
driver. It runs >=1024-frame sequences at the
round-4 bench defaults (host-compact ingest, point_budget=8192,
max_cells=1024, Morton spatial sort, block-sparse association):

  easy        : default world, 12 m/s, ~3 km path
  adversarial : 40 moving objects, azimuth dropout p=0.5, interference
                bursts p=0.4 (the hardened regime of the ablation sweep)

Each easy run is ALSO executed split at the midpoint through
`save_checkpoint`/`resume`, asserting the resumed trajectory is
bit-identical to the unsplit one (the checkpoint carries the full
scan-carry state). Scores use the real KITTI evaluator (`eval/kitti.py`,
100-800 m subsequences — the metric the reference is judged by,
README.md:68-90). Writes `eval_results/LONGRUN_1024.txt`.

Usage: python tools/run_longrun.py [--frames 1024] [--out ...]
(default JAX platform; --cpu for a small smoke run.)
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--speed", type=float, default=12.0)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--extent", type=float, default=1000.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--max-cells", type=int, default=2048,
                    help="cell budget: the extent-1000 worlds are ~40x "
                         "denser than the short bench world, so occupancy "
                         "exceeds the bench-default 1024 budget")
    ap.add_argument("--health-every", type=int, default=8,
                    help="reverse-registration health check period "
                         "(odometry.health_check_every; 0 disables)")
    ap.add_argument("--out", default="eval_results/LONGRUN_1024.txt")
    args = ap.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from cfear_jax.utils.runtime import setup_compile_cache
    setup_compile_cache()
    from cfear_jax.config import preset
    from cfear_jax.datasets import synthetic
    from cfear_jax.models import odometry
    from cfear_jax.eval.kitti import kitti_drift

    cfg = preset("CFEAR-3", dataset="oxford")
    cfg = cfg.replace(
        feature=dataclasses.replace(
            cfg.feature, max_cells=args.max_cells, point_budget=8192,
            spatial_sort=True),
        odometry=dataclasses.replace(
            cfg.odometry, health_check_every=args.health_every))
    lines = [f"long-run drift at round-5 defaults "
             f"(backend={jax.default_backend()}, ingest=host-compact, "
             f"point_budget=8192, max_cells={args.max_cells}, "
             f"spatial_sort, assoc auto/block-sparse, "
             f"health_check_every={args.health_every})"]

    worlds = [
        ("easy", args.speed, dict()),
        ("adversarial", args.speed, dict(n_dynamic=40, dropout_prob=0.5,
                                         speckle_burst_prob=0.4)),
        # continuity row with the r2-era artifact (which ran 8 m/s)
        ("adversarial_8ms", 8.0, dict(n_dynamic=40, dropout_prob=0.5,
                                      speckle_burst_prob=0.4)),
    ]
    for name, speed, adv in worlds:
        t0 = time.time()
        images, gt = synthetic.make_sequence(
            seed=11, n_frames=args.frames, cfg=cfg, speed=speed,
            extent=args.extent, **adv)
        render_s = time.time() - t0
        gt = np.asarray(gt)
        path = float(np.sum(np.linalg.norm(np.diff(gt[:, :2], axis=0),
                                           axis=1)))

        runner = odometry.OdometryRunner(cfg, chunk=args.chunk,
                                         ingest="host")
        # untimed warm pass: compile (OdometryRunner.reset keeps the
        # jitted executables for the timed passes)
        runner.process(images)
        _ = np.asarray(runner.outputs[-1].pose)
        walls = []
        for _pass in range(3):
            runner.reset()
            t0 = time.time()
            runner.process(images)
            traj = np.asarray(runner.trajectory())
            walls.append(time.time() - t0)
        wall = float(np.median(walls))
        fps = args.frames / wall
        drift = kitti_drift(traj, gt)       # FULL 100-800 m protocol
        out_f = runner.frame_outputs()
        fails = int((~np.asarray(out_f.success)).sum())
        mean_cells = float(np.asarray(out_f.num_cells).mean())
        checked = np.asarray(out_f.health_checked)
        n_checked = int(checked.sum())
        unhealthy = float((~np.asarray(out_f.healthy)[checked]).mean()) \
            if n_checked else float("nan")
        med_hdist = float(np.median(np.asarray(
            out_f.health_dist)[checked])) if n_checked else float("nan")
        per_len = " ".join(
            f"{k}m:{v['t_err_percent']:.3f}%"
            for k, v in sorted(drift.get("per_length", {}).items()))
        lines.append(
            f"{name} ({speed:.0f} m/s): {args.frames} frames, path "
            f"{path:.0f} m, render "
            f"{render_s:.0f}s, median {wall:.1f}s of {[round(w, 1) for w in walls]} "
            f"-> {fps:.1f} fps; KITTI "
            f"t_err {drift['t_err_percent']:.3f}% r_err "
            f"{drift['r_err_deg_per_m']:.5f} deg/m "
            f"({drift['n_subsequences']} subseqs: {per_len}); "
            f"failures {fails}; mean cells {mean_cells:.0f}; "
            f"health: {n_checked} checks, unhealthy {unhealthy:.1%}, "
            f"median rev-discrepancy {med_hdist:.3f} m")
        print(lines[-1], flush=True)

        if name == "easy":
            # mid-run checkpoint/resume: bit-identical trajectory
            half = (args.frames // 2 // args.chunk) * args.chunk
            ck = "/tmp/longrun_ckpt.npz"
            r1 = odometry.OdometryRunner(cfg, chunk=args.chunk,
                                         ingest="host")
            r1.process(images[:half])
            r1.save_checkpoint(ck)
            r2 = odometry.OdometryRunner.resume(cfg, ck, chunk=args.chunk,
                                                ingest="host")
            r2.process(images[half:])
            traj2 = np.asarray(r2.trajectory())
            identical = bool(np.array_equal(traj2, traj))
            max_dev = float(np.abs(traj2 - traj).max())
            lines.append(
                f"checkpoint/resume split@{half}: bit-identical="
                f"{identical} (max |delta| {max_dev:.2e})")
            print(lines[-1], flush=True)
            if not identical and max_dev > 1e-9:
                raise SystemExit(
                    f"resume trajectory deviates by {max_dev}")

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
