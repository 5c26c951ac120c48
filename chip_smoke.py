"""Smoke test of the odometry engine on an NVIDIA GPU, through its normal
entry points, at CFEAR-3 Oxford Radar RobotCar geometry (400 azimuths x
3768 bins at 0.0438 m, k=40, max_cells=1024, point_budget=8192) on
synthetic sweeps rendered from fixed seeds.

    python chip_smoke.py               # one card: phases 0-5
    python chip_smoke.py --four-cards  # four cards: the multi-card path only

Phases (one card):
  0 set-up: card, JAX, XLA flags, compile cache, host filter
  1 the association kernel against the plain XLA reference, S=4 and S=50
  2 single stream (OdometryRunner, host ingest), 128 frames: no failures,
    short-protocol drift < 0.5 %, the first 16 frames again on the CPU
  3 eight distinct sequences through the batched step on a one-card mesh,
    each lane against its own single-stream run
  4 CFEAR-3-s50 (50 keyframes, Morton-sorted cells), 64 frames
  5 pose-graph optimization of phase 2's keyframes with loop edges
Four cards: four sequences data-parallel over a 4-card mesh against the
same lanes on one card, and the edge-sharded pose-graph solve of a
loop-closed graph against the single-device solve.

Pose tolerances compare each frame's pose estimate, its motion from the
previous frame. GPU against CPU (phase 2): every frame within 1e-3 m and
1e-4 rad. A second pass of the same program on the same input (phases
2-4) must give the same bits. Batched lanes against single streams (phase
3) and a 4-card mesh against one card are other compiled programs, whose
registration loop rounds differently; each lane is held on its own to
LANE_POS_TOL / LANE_ROT_TOL on every frame and to the drift limit against
ground truth (see LANE_POS_TOL).

Every phase raises on failure; the process then exits non-zero without
printing a result. The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

import os

# the card is the default backend; the CPU backend exists for cross-checks
os.environ["JAX_PLATFORMS"] = "cuda,cpu"

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

POS_TOL = 1e-3            # m
ROT_TOL = 1e-4            # rad
DRIFT_MAX = 0.5           # % (short 50/100 m protocol)
# Each stage of a registration (world attributes, association, packing,
# LM normal equations, LM solve) gives the same bits alone and vmapped over
# 8 lanes on an H100, but the compiled registration loop does not: it
# differs in the last bits from the first frame on, and the stopping rules
# (relative improvement < 1e-5, roll back when the score rises,
# `n_scan_normal.cpp:134-149`) turn that into another stopping iterate on
# some frames, after which a lane follows another, equally valid
# trajectory. Measured between the batched and single-stream programs on
# an H100 (700 W), 8 lanes x 64 frames at 6 m/s: up to 1.82 cm / 5.97e-4
# rad on a frame, 5 of 8 lanes beyond 1e-3 m. A lane fault (another lane's
# map, a wrong compensation) moves a lane's drift against ground truth;
# each lane is held to both.
LANE_POS_TOL = 0.03       # m
LANE_ROT_TOL = 1e-3       # rad
LANE_DRIFT_LENGTHS = (25.0, 50.0)   # m; lanes of 32-64 frames


def log(msg):
    print(msg, flush=True)


def _peak_bytes(dev):
    return (dev.memory_stats() or {}).get("peak_bytes_in_use", "n/a")


def _oxford_cfg(name="CFEAR-3"):
    from cfear_jax.config import preset
    cfg = preset(name, dataset="oxford")
    return cfg.replace(feature=dataclasses.replace(
        cfg.feature, max_cells=1024, point_budget=8192, spatial_sort=True))


def _sequence(cfg, seed, n_frames, speed=6.0):
    from cfear_jax.datasets import synthetic
    return synthetic.make_sequence(seed=seed, n_frames=n_frames, cfg=cfg,
                                   speed=speed)


def _motions(traj):
    """Per-frame motion (T-1, 3): pose k in the frame of pose k-1."""
    d = traj[1:, :2] - traj[:-1, :2]
    c, s = np.cos(traj[:-1, 2]), np.sin(traj[:-1, 2])
    dth = traj[1:, 2] - traj[:-1, 2]
    return np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1],
                     np.arctan2(np.sin(dth), np.cos(dth))], -1)


def _pose_err(a, b):
    """Max translation (m) and rotation (rad) difference of (T, 3) poses."""
    dxy = float(np.max(np.linalg.norm(a[:, :2] - b[:, :2], axis=-1)))
    dth = np.arctan2(np.sin(a[:, 2] - b[:, 2]), np.cos(a[:, 2] - b[:, 2]))
    return dxy, float(np.max(np.abs(dth)))


def _frame_diffs(what, a, b):
    """Per-frame pose-estimate differences (|dxy| m, |dyaw| rad) of two
    (T, 3) trajectories: each frame's motion from the previous frame. The
    composed trajectories are reported too; they integrate every per-frame
    difference."""
    ma, mb = _motions(a), _motions(b)
    dxy = np.linalg.norm(ma[:, :2] - mb[:, :2], axis=-1)
    dth = np.abs(np.arctan2(np.sin(ma[:, 2] - mb[:, 2]),
                            np.cos(ma[:, 2] - mb[:, 2])))
    within = (dxy <= POS_TOL) & (dth <= ROT_TOL)
    gxy, gth = _pose_err(a, b)
    log(f"  {what}: {int(within.sum())}/{len(within)} frames within "
        f"{POS_TOL} m / {ROT_TOL} rad; per-frame max |dxy| "
        f"{dxy.max():.3g} m, |dyaw| {dth.max():.3g} rad; trajectory max "
        f"|dxy| {gxy:.3g} m, |dyaw| {gth:.3g} rad")
    return dxy, dth


def _check_poses(what, a, b):
    """Every frame within POS_TOL / ROT_TOL."""
    dxy, dth = _frame_diffs(what, a, b)
    if not (dxy.max() <= POS_TOL and dth.max() <= ROT_TOL):
        raise AssertionError(f"{what}: per-frame poses disagree")


def _check_lanes(what, pairs):
    """Lanes of two compiled programs, [(label, traj_a, traj_b, gt)],
    each on its own: every frame within LANE_POS_TOL / LANE_ROT_TOL, and
    both trajectories' drift against `gt` below DRIFT_MAX."""
    from cfear_jax.eval.kitti import kitti_drift
    bad = []
    for label, a, b, gt in pairs:
        dxy, dth = _frame_diffs(label, a, b)
        drift = [kitti_drift(t, gt, step_size=5, lengths=LANE_DRIFT_LENGTHS)
                 for t in (a, b)]
        log(f"    drift {drift[0]['t_err_percent']:.3f} % vs "
            f"{drift[1]['t_err_percent']:.3f} % "
            f"({drift[0]['n_subsequences']} subsequences)")
        if not (dxy.max() <= LANE_POS_TOL and dth.max() <= LANE_ROT_TOL
                and all(d["n_subsequences"] and d["t_err_percent"]
                        < DRIFT_MAX for d in drift)):
            bad.append(label)
    n_equal = sum(np.array_equal(a, b) for _, a, b, _ in pairs)
    log(f"  {what}: {n_equal}/{len(pairs)} lanes equal to the bit")
    if bad:
        raise AssertionError(f"{what}: lanes disagree: {bad}")


def _check_repeat(what, a, b):
    """Two passes of one program on one input: the same bits."""
    a, b = np.asarray(a), np.asarray(b)
    diff = float(np.max(np.abs(a - b))) if a.size else 0.0
    log(f"  repeat, {what}: max |difference| {diff:.3g}")
    if not np.array_equal(a, b):
        raise AssertionError(f"{what}: a second pass gave other bits")


def _timed(fn, *args, repeats=2):
    """(output, first-call seconds, median warm seconds)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    warm = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        warm.append(time.perf_counter() - t0)
    return out, first, float(np.median(warm))


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------

def phase0():
    import jax
    from cfear_jax.utils import native_io, runtime

    if jax.default_backend() != "gpu":
        raise RuntimeError(f"no GPU: JAX backend is {jax.default_backend()}")
    cache = runtime.setup_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = jax.devices()[0]
    log("phase 0: set-up")
    log(f"  card: {card}")
    log(f"  jax {jax.__version__}, devices {len(jax.devices())} x "
        f"{dev.device_kind}")
    log(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"  compile cache: {cache}")
    log(f"  host filter: "
        f"{'native' if native_io.native_available() else 'numpy'}")
    return card


# ---------------------------------------------------------------------------
# phase 1: kernel against the plain reference
# ---------------------------------------------------------------------------

def _windows(cfg, s, n_src, seed=1):
    """n_src source cell maps, each with the S preceding frames as its
    keyframe window, all in the source frame's coordinates."""
    import jax
    import jax.numpy as jnp
    from cfear_jax.ops import features, filtering, registration
    from cfear_jax.utils import se2

    images, gt = _sequence(cfg, seed, s + n_src)
    pts = jax.jit(jax.vmap(lambda im: filtering.filter_polar_image(
        im, cfg)))(images)
    cells = jax.jit(lambda p: features.compute_cells_batched(p, cfg))(pts)
    gt = jnp.asarray(gt, jnp.float32)
    src_xy, src_v, tar_xy, tar_v = [], [], [], []
    for t in range(n_src):
        fs = s + t
        poses = se2.compose(se2.inverse(gt[fs])[None], gt[t:fs])
        at = registration._world_attrs(
            jax.tree.map(lambda a: a[t:fs], cells), poses, cfg)
        src_xy.append(cells.mean[fs])
        src_v.append(cells.valid[fs])
        tar_xy.append(at[..., 0:2])
        tar_v.append(at[..., 6] > 0.5)
    return tuple(jnp.stack(v) for v in (src_xy, src_v, tar_xy, tar_v))


def phase1():
    import jax
    from cfear_jax.ops import pallas_assoc, registration

    log("phase 1: association kernel vs plain XLA reference (M=1024)")
    cfg = _oxford_cfg()
    radius = 2.0 * cfg.registration.assoc_radius     # first-iteration gate
    for s in (4, 50):
        xs = _windows(cfg, s, 8)

        def scan(fn):
            return jax.jit(lambda *a: jax.lax.scan(
                lambda c, x: (c, fn(*x)), 0, a)[1])

        kern = scan(lambda sx, sv, tx, tv: pallas_assoc.nn_min(
            sx, sv, tx, tv, radius))
        ref = scan(lambda sx, sv, tx, tv: registration.nn_dense(sx, tx, tv))
        second = scan(lambda sx, sv, tx, tv: _second_best(sx, tx, tv))
        (nn, d2), k_first, k_warm = _timed(kern, *xs)
        (rn, rd), r_first, r_warm = _timed(ref, *xs)
        d2b = second(*xs)
        nn, d2, rn, rd, d2b = map(np.asarray, (nn, d2, rn, rd, d2b))
        keep = (rd <= radius * radius) & np.asarray(xs[1])[:, None, :]
        unique = (d2b - rd) > 1e-6 * np.maximum(1.0, rd)
        bad_nn = int(np.sum(keep & unique & (nn != rn)))
        bad_d2 = int(np.sum(keep & ~np.isclose(d2, rd, rtol=1e-6,
                                               atol=1e-6)))
        n = xs[0].shape[0]
        log(f"  S={s}: {int(keep.sum())} rows within the radius, nn "
            f"mismatches {bad_nn}, d2 mismatches {bad_d2} (rows whose d2 "
            f"differs in any bit {int(np.sum(keep & (d2 != rd)))}, ties "
            f"with another nn {int(np.sum(keep & ~unique & (nn != rn)))}); "
            f"kernel "
            f"{k_warm / n * 1e3:.3f} ms/call (compile+first "
            f"{k_first:.1f} s), XLA {r_warm / n * 1e3:.3f} ms/call "
            f"(compile+first {r_first:.1f} s)")
        if bad_nn or bad_d2 or not keep.any():
            raise AssertionError(f"kernel disagrees with the reference "
                                 f"at S={s}")


def _second_best(sx, tx, tv):
    """Second-smallest valid distance per (keyframe, source row)."""
    import jax
    import jax.numpy as jnp
    d = sx[None, :, None, :] - tx[:, None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    d2 = jnp.where(tv[:, None, :], d2, jnp.inf)
    return -jax.lax.top_k(-d2, 2)[0][..., 1]


# ---------------------------------------------------------------------------
# phase 2: single stream
# ---------------------------------------------------------------------------

def _single_stream(cfg, images, runner=None, warm_pass=True):
    """(trajectory, frame outputs, first-pass s, warm frames/s, runner) of
    the last pass. With `warm_pass` the sequence runs twice, and the second
    pass must give the first pass's bits."""
    import jax
    from cfear_jax.models.odometry import OdometryRunner
    runner = runner or OdometryRunner(cfg, chunk=16, ingest="host")
    fps, trajs = None, []
    for n_pass in range(2 if warm_pass else 1):
        runner.reset()
        t0 = time.perf_counter()
        runner.process(images)
        jax.block_until_ready(runner.outputs)
        secs = time.perf_counter() - t0
        trajs.append(runner.trajectory())
        if n_pass == 0:
            first = secs
        else:
            fps = len(images) / secs
    if warm_pass:
        _check_repeat(f"{cfg.name} single stream", trajs[0], trajs[1])
    return trajs[-1], runner.frame_outputs(), first, fps, runner


def phase2(dev):
    import jax
    from cfear_jax.eval.kitti import kitti_drift
    from cfear_jax.models.odometry import OdometryRunner

    log("phase 2: single stream, CFEAR-3, 128 frames, seed 1, 6 m/s")
    cfg = _oxford_cfg()
    images, gt = _sequence(cfg, 1, 128)
    traj, fo, first, fps, runner = _single_stream(cfg, images)
    fails = int((~fo.success).sum())
    drift = kitti_drift(traj, gt, step_size=5, lengths=(50.0, 100.0))
    log(f"  compile+first pass {first:.1f} s; warm {fps:.1f} frames/s; "
        f"peak_bytes_in_use {_peak_bytes(dev)}")
    log(f"  failures {fails}; drift {drift['t_err_percent']:.3f} % "
        f"({drift['n_subsequences']} subsequences); mean outer iterations "
        f"{fo.reg_iterations[1:].mean():.2f}")
    if fails or not drift["n_subsequences"] \
            or not drift["t_err_percent"] < DRIFT_MAX:
        raise AssertionError("single stream: failures or drift over limit")

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        r_cpu = OdometryRunner(cfg, chunk=16, ingest="host")
        r_cpu.process(images[:16])
        traj_cpu = r_cpu.trajectory()
    _check_poses("GPU vs CPU, frames 0-15", traj[:16], traj_cpu)
    return cfg, images, gt, traj, fo, runner


# ---------------------------------------------------------------------------
# phase 3: batched
# ---------------------------------------------------------------------------

def _batched(cfg, images, mesh, repeats=2):
    """Distinct sequences (B, T, A, R) through the batched step on `mesh`:
    (trajectories (B, T, 3), keyframe flags (B, T), failures, compile s,
    warm frames/s, memory analysis of the compiled step)."""
    import jax
    import jax.numpy as jnp
    from cfear_jax.models import odometry
    from cfear_jax.parallel.mesh import MultiSequenceRunner

    b, t = images.shape[:2]
    runner = MultiSequenceRunner(cfg, b, mesh=mesh, chunk=t - 1,
                                 ingest="host")
    inp = runner._prepare(images)
    first = runner.shard_batch(jax.tree.map(lambda x: jnp.asarray(x[:, 0]),
                                            inp))
    states, out0 = runner.bootstrap_batch(runner.states, first)
    rest = runner.shard_batch(jax.tree.map(lambda x: jnp.asarray(x[:, 1:]),
                                           inp))
    t0 = time.perf_counter()
    step = runner.step_chunk.lower(states, rest).compile()
    compile_s = time.perf_counter() - t0
    (_, out), _, warm = _timed(step, states, rest, repeats=repeats)
    _check_repeat(f"batched step, {b} lanes", step(states, rest)[1].pose,
                  out.pose)
    out = jax.tree.map(lambda a0, a: np.concatenate(
        [np.asarray(a0)[:, None], np.asarray(a)], axis=1), out0, out)
    trajs = np.stack([odometry.compose_trajectory(
        jax.tree.map(lambda a, i=i: a[i], out)) for i in range(b)])
    return trajs, out.fused, int((~out.success).sum()), compile_s, \
        b * (t - 1) / warm, step.memory_analysis()


def phase3(dev, cfg, runner):
    from cfear_jax.parallel.mesh import make_mesh

    log("phase 3: batched x8, distinct seeds 1-8, 64 frames each at 6 m/s, "
        "one-card mesh")
    seqs = [_sequence(cfg, seed, 64) for seed in range(1, 9)]
    images = np.stack([im for im, _ in seqs])
    trajs, fused, fails, compile_s, fps, mem = _batched(cfg, images,
                                                        make_mesh(1))
    log(f"  compile {compile_s:.1f} s; warm {fps:.1f} frames/s "
        f"(8 lanes); failures {fails}; peak_bytes_in_use {_peak_bytes(dev)}")
    log(f"  memory_analysis of the batched step: {mem}")
    if fails:
        raise AssertionError("batched: registration failures")
    pairs = []
    for lane, (im, gt) in enumerate(seqs):
        traj, fo, _, _, _ = _single_stream(cfg, im, runner, warm_pass=False)
        if int((~fo.success).sum()):
            raise AssertionError(f"single stream seed {lane + 1} failed")
        pairs.append((f"lane {lane} vs single stream seed {lane + 1} "
                      f"({int((fused[lane] != fo.fused).sum())} keyframe "
                      f"decisions differ)", trajs[lane], traj, gt))
    _check_lanes("batched vs single stream", pairs)


# ---------------------------------------------------------------------------
# phase 4: large submap
# ---------------------------------------------------------------------------

def phase4(dev):
    from cfear_jax.ops import registration

    log("phase 4: CFEAR-3-s50 (50 keyframes, Morton-sorted), 64 frames")
    cfg = _oxford_cfg("CFEAR-3-s50")
    log(f"  association backend: {registration.resolve_assoc_method(cfg, 50)}")
    images, gt = _sequence(cfg, 2, 64)
    traj, fo, first, fps, _ = _single_stream(cfg, images)
    fails = int((~fo.success).sum())
    log(f"  compile+first pass {first:.1f} s; warm {fps:.1f} frames/s; "
        f"failures {fails}; peak_bytes_in_use {_peak_bytes(dev)}")
    if fails:
        raise AssertionError("s50: registration failures")


# ---------------------------------------------------------------------------
# phase 5: pose graph
# ---------------------------------------------------------------------------

def phase5(dev, gt, traj, fo):
    import jax
    import jax.numpy as jnp
    from cfear_jax.models import posegraph
    from cfear_jax.utils import se2

    log("phase 5: pose graph of phase 2's keyframes + loop edges")
    gb = posegraph.build_graph_from_odometry(fo, traj)
    kf = np.where(np.asarray(fo.fused))[0]
    cov = np.diag([0.01, 0.01, 1e-4])
    for a in range(0, len(kf) - 10, 3):       # verified-loop stand-ins
        t_ij = np.asarray(se2.relative(jnp.asarray(gt[kf[a]], jnp.float32),
                                       jnp.asarray(gt[kf[a + 10]],
                                                   jnp.float32)))
        gb.add_loop_edge(a, a + 10, t_ij, cov)
    graph = gb.to_arrays()
    cost0 = float(posegraph.total_cost(graph))
    t0 = time.perf_counter()
    opt, _ = posegraph.optimize(graph, iters=10, cg_iters=50)
    jax.block_until_ready(opt.poses)
    secs = time.perf_counter() - t0
    cost1 = float(posegraph.total_cost(opt))
    poses = np.asarray(opt.poses)
    log(f"  {len(gb.poses)} nodes, {len(gb.edges)} edges; cost {cost0:.4f} "
        f"-> {cost1:.4f}; compile+solve {secs:.1f} s; peak_bytes_in_use "
        f"{_peak_bytes(dev)}")
    if not (np.isfinite(poses).all() and cost1 <= cost0):
        raise AssertionError("pose graph: non-finite poses or cost rose")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _loop_graph(n_per_lap=260, laps=4, radius=30.0, seed=3):
    """A loop-closed circuit graph of n_per_lap * laps nodes."""
    import jax.numpy as jnp
    from cfear_jax.models import posegraph
    from cfear_jax.utils import se2

    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n_per_lap, endpoint=False)
    lap = np.stack([radius * np.sin(th), radius * (1 - np.cos(th)), th], -1)
    gt = np.concatenate([lap] * laps)
    gb = posegraph.GraphBuilder()
    est = np.zeros(3)
    info_odo = np.diag([1e4, 1e4, 4e4])
    info_loop = np.diag([4e3, 4e3, 1.6e4])
    for k in range(len(gt)):
        gb.add_node(est.copy(), k * 0.25)
        if k + 1 < len(gt):
            rel = np.asarray(se2.relative(jnp.asarray(gt[k], jnp.float32),
                                          jnp.asarray(gt[k + 1],
                                                      jnp.float32)))
            noisy = rel + rng.normal(0, [0.02, 0.02, 0.002])
            c, s = np.cos(est[2]), np.sin(est[2])
            est = est + [c * noisy[0] - s * noisy[1],
                         s * noisy[0] + c * noisy[1], noisy[2]]
            gb.edges.append((k, k + 1, noisy, info_odo, posegraph.ODOMETRY))
    for lp in range(1, laps):
        for k in range(0, n_per_lap, 5):
            i, j = k, lp * n_per_lap + k
            rel = np.asarray(se2.relative(jnp.asarray(gt[i], jnp.float32),
                                          jnp.asarray(gt[j], jnp.float32)))
            gb.edges.append((i, j, rel, info_loop,
                             posegraph.LOOP_APPEARANCE))
    return gb.to_arrays()


def four_cards(devices):
    """The multi-card path and its one-card comparison, on `devices`."""
    import jax
    from jax.sharding import Mesh
    from cfear_jax.models import posegraph
    from cfear_jax.parallel import pgo

    n = len(devices)
    log(f"four cards: {n} x {devices[0].device_kind}")
    cfg = _oxford_cfg()
    seqs = [_sequence(cfg, seed, 32) for seed in range(1, n + 1)]
    images = np.stack([im for im, _ in seqs])
    mesh_n = Mesh(np.array(devices), ("data",))
    mesh_1 = Mesh(np.array(devices[:1]), ("data",))
    tr_n, kf_n, fails_n, c_n, fps_n, _ = _batched(cfg, images, mesh_n)
    tr_1, kf_1, fails_1, c_1, fps_1, _ = _batched(cfg, images, mesh_1)
    log(f"  odometry: {n} lanes x 32 frames; {n}-card mesh compile "
        f"{c_n:.1f} s, warm {fps_n:.1f} frames/s; one card compile "
        f"{c_1:.1f} s, warm {fps_1:.1f} frames/s; failures "
        f"{fails_n}/{fails_1}")
    if fails_n or fails_1:
        raise AssertionError("four cards: registration failures")
    _check_lanes(f"{n}-card mesh vs one card", [
        (f"lane {lane}: {n}-card mesh vs one card "
         f"({int((kf_n[lane] != kf_1[lane]).sum())} keyframe decisions "
         f"differ)", tr_n[lane], tr_1[lane], seqs[lane][1])
        for lane in range(n)])

    graph = _loop_graph()
    t0 = time.perf_counter()
    opt_d, cost_d = pgo.distributed_optimize(graph, mesh_n, iters=8,
                                             cg_iters=200)
    jax.block_until_ready(opt_d.poses)
    t_d = time.perf_counter() - t0
    with jax.default_device(devices[0]):
        t0 = time.perf_counter()
        opt_s, cost_s = posegraph.optimize(graph, iters=8, cg_iters=200)
        jax.block_until_ready(opt_s.poses)
        t_s = time.perf_counter() - t0
    pd, ps = np.asarray(opt_d.poses), np.asarray(opt_s.poses)
    dxy = float(np.max(np.linalg.norm(pd[:, :2] - ps[:, :2], axis=-1)))
    log(f"  pose graph: {graph.poses.shape[0]} nodes, "
        f"{int(np.asarray(graph.edge_valid).sum())} edges; distributed "
        f"{t_d:.1f} s, one card {t_s:.1f} s (compile included); cost "
        f"{float(cost_d):.4f} vs {float(cost_s):.4f}; max |dxy| {dxy:.3g} m")
    if not (np.isfinite(pd).all() and dxy <= 1e-4):
        raise AssertionError("distributed pose graph disagrees")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card path and its comparison")
    args = ap.parse_args(argv)

    import jax

    card = phase0()
    devices = jax.devices()
    if args.four_cards:
        if len(devices) < 4:
            raise RuntimeError(f"--four-cards needs 4 GPUs, found "
                               f"{len(devices)}")
        devices = devices[:4]
        four_cards(devices)
    else:
        dev = devices[0]
        phase1()
        cfg, images, gt, traj, fo, runner = phase2(dev)
        phase3(dev, cfg, runner)
        phase4(dev)
        phase5(dev, gt, traj, fo)
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
