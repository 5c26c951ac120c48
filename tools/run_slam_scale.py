"""Full-Oxford-scale SLAM pass artifact (VERDICT r4 next-step #3).

A multi-lap circuit (laps of the same closed loop in one world -> every
lap after the first is loop-rich against all previous laps) at Oxford
sensor scale, sized to >= 1000 keyframes. Runs the complete SLAM stack —
odometry, graph build with scan payloads, ring-key descriptor pass, loop
proposal, CHUNKED batched verification (`LoopCloser._verify`: fixed
512-pair executable, bounded device memory), mini-loops, robust GN/CG
optimization — and commits per-stage wall time plus keyframe ATE before/
after closure. Done-criterion: closed-loop ATE < odometry ATE, with host
stages visibly sub-linear in the table.

Usage: python tools/run_slam_scale.py [--frames 4096 --lap-frames 1024]
(default JAX platform; --cpu --frames 256 for a smoke run.)
Writes eval_results/SLAM_SCALE.txt.
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
    ap.add_argument("--frames", type=int, default=4096)
    ap.add_argument("--lap-frames", type=int, default=1024)
    ap.add_argument("--speed", type=float, default=2.5)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--max-cells", type=int, default=1024)
    ap.add_argument("--extent", type=float, default=300.0)
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="azimuth-wedge dropout probability: degrades the "
                         "odometry so RANDOM drift (the loop-observable "
                         "kind) dominates the lap-coherent systematic "
                         "drift of the clean world")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--cg-iters", type=int, default=400,
                    help="PCG iterations per GN step; ~400 needed at "
                         ">=1000 nodes even with the block-Jacobi "
                         "preconditioner (long-wavelength modes)")
    ap.add_argument("--mini-loops", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="eval_results/SLAM_SCALE.txt")
    args = ap.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from cfear_jax.utils.runtime import setup_compile_cache
    setup_compile_cache()
    from cfear_jax.config import preset
    from cfear_jax.datasets import synthetic
    from cfear_jax.models import (loopclosure,
                                                            odometry,
                                                            posegraph)

    cfg = preset("CFEAR-3", dataset="oxford" if not args.cpu else "synthetic")
    cfg = cfg.replace(feature=dataclasses.replace(
        cfg.feature, max_cells=args.max_cells, point_budget=8192,
        spatial_sort=True))

    lines = [f"full-scale SLAM pass (backend={jax.default_backend()}, "
             f"{args.frames} frames = {args.frames / args.lap_frames:.1f} "
             f"laps x {args.lap_frames}, speed {args.speed} m/s, extent "
             f"{args.extent}, max_cells={args.max_cells}, verify chunk "
             f"{loopclosure.LoopCloser.VERIFY_CHUNK})"]

    def stage(name, t0):
        dt = time.time() - t0
        lines.append(f"  {name:28s} {dt:8.1f} s")
        print(lines[-1], flush=True)
        return time.time()

    # --- world + multi-lap ground truth + render --------------------------
    t0 = time.time()
    rng = np.random.default_rng(9)
    scale = (args.extent / 160.0) ** 2
    world = synthetic.make_world(
        rng, extent=args.extent, n_walls=max(18, int(18 * scale)),
        n_scatterers=max(250, int(250 * scale)))
    lap = synthetic.make_loop_trajectory(
        args.lap_frames, dt=cfg.radar.sensor_period, speed=args.speed)
    laps = -(-args.frames // args.lap_frames)
    gt = np.concatenate([lap] * laps)[:args.frames]
    images = np.zeros((args.frames, cfg.radar.n_azimuths, cfg.radar.n_bins),
                      np.uint8)
    dt_s = cfg.radar.sensor_period
    for i in range(args.frames):
        motion = None
        if i > 0:
            prev, cur = gt[i - 1], gt[i]
            c, s = np.cos(prev[2]), np.sin(prev[2])
            motion = np.array([c * (cur[0] - prev[0]) + s * (cur[1] - prev[1]),
                               -s * (cur[0] - prev[0]) + c * (cur[1] - prev[1]),
                               np.angle(np.exp(1j * (cur[2] - prev[2])))])
        images[i] = synthetic.render_polar(world, gt[i], cfg, rng,
                                           motion=motion, t=i * dt_s,
                                           dropout_prob=args.dropout)
    t0 = stage(f"render ({args.frames} frames, dropout={args.dropout})", t0)

    # --- odometry ---------------------------------------------------------
    runner = odometry.OdometryRunner(cfg, chunk=args.chunk, ingest="host")
    runner.process(images)
    traj = np.asarray(runner.trajectory())
    out = runner.frame_outputs()
    t0 = stage("odometry (incl. compile)", t0)

    kf_frames = np.where(np.asarray(out.fused))[0]
    n_kf = len(kf_frames)
    lines.append(f"  keyframes: {n_kf} of {args.frames} frames; "
                 f"failures {int((~np.asarray(out.success)).sum())}")
    print(lines[-1], flush=True)

    gb = posegraph.build_graph_from_odometry(out, traj, images=images,
                                             cfg=cfg)
    t0 = stage("graph build + payloads", t0)

    # --- loop closure, stage by stage ------------------------------------
    closer = loopclosure.LoopCloser(cfg)
    import jax.numpy as jnp
    m = cfg.feature.max_cells
    stacked = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[posegraph.payload_to_cellmap(s, m) for s in gb.scans])
    t0 = stage("payload stack", t0)
    rk, sh = jax.tree.map(np.asarray, closer._desc_fn(stacked))
    t0 = stage("descriptor pass", t0)

    accepted = closer.close_from_graph(gb, precomputed=(stacked, rk, sh))
    n_loops = len(accepted)
    n_cand = gb.n_constraints(posegraph.CANDIDATE)
    t0 = stage(f"proposal+verify+accept", t0)
    lines.append(f"  accepted loop edges: {n_loops}; stored candidates: "
                 f"{n_cand}")
    print(lines[-1], flush=True)

    if args.mini_loops:
        closer.add_mini_loops(gb)
        t0 = stage("mini loops", t0)

    graph = gb.to_arrays()
    t0 = stage("to_arrays", t0)
    opt, costs = posegraph.optimize(graph, iters=args.iters,
                                    cg_iters=args.cg_iters)
    opt = np.asarray(opt.poses)[:n_kf]
    t0 = stage(f"optimize ({args.iters} GN x {args.cg_iters} PCG)", t0)

    # loop-residual health: the optimizer must close the loop-OBSERVABLE
    # error even when ATE-vs-GT is dominated by lap-coherent systematic
    # drift that no loop can see (all laps drift together)
    from cfear_jax.utils import se2 as _se2

    def _loop_res(poses_arr):
        r = []
        for (i, j, tij, info, kind) in gb.edges:
            if kind == posegraph.LOOP_APPEARANCE:
                rel = np.asarray(_se2.relative(
                    jnp.asarray(poses_arr[i], jnp.float32),
                    jnp.asarray(poses_arr[j], jnp.float32)))
                r.append(np.linalg.norm((rel - np.asarray(tij))[:2]))
        return np.asarray(r) if r else np.zeros(1)

    lr0 = _loop_res(traj[kf_frames])
    lr1 = _loop_res(opt)
    lines.append(
        f"  loop residuals: init median {np.median(lr0):.3f} m "
        f"(p90 {np.percentile(lr0, 90):.3f}) -> optimized median "
        f"{np.median(lr1):.3f} m (p90 {np.percentile(lr1, 90):.3f})")
    print(lines[-1], flush=True)

    # --- ATE before/after -------------------------------------------------
    gt_kf = gt[kf_frames]
    before = traj[kf_frames]

    def ate(est):
        # keyframe ATE after a rigid (Umeyama-style, yaw-only) alignment
        # of est to gt so the metric measures map consistency, not the
        # global gauge
        mu_e = est[:, :2].mean(0)
        mu_g = gt_kf[:, :2].mean(0)
        e = est[:, :2] - mu_e
        g = gt_kf[:, :2] - mu_g
        num = np.sum(e[:, 0] * g[:, 1] - e[:, 1] * g[:, 0])
        den = np.sum(e[:, 0] * g[:, 0] + e[:, 1] * g[:, 1])
        th = np.arctan2(num, den)
        c, s = np.cos(th), np.sin(th)
        er = np.stack([c * e[:, 0] - s * e[:, 1],
                       s * e[:, 0] + c * e[:, 1]], -1)
        return float(np.sqrt(np.mean(np.sum((er - g) ** 2, -1))))

    ate_odo = ate(before)
    ate_slam = ate(opt)
    lines.append(f"  keyframe ATE: odometry {ate_odo:.3f} m -> closed "
                 f"{ate_slam:.3f} m ({n_loops} loop edges over {n_kf} "
                 f"keyframes)")
    print(lines[-1], flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}")
    if n_loops and ate_slam > ate_odo:
        print("WARNING: closure did not improve keyframe ATE")
    return dict(n_kf=n_kf, n_loops=n_loops, ate_odo=ate_odo,
                ate_slam=ate_slam)


if __name__ == "__main__":
    main()
