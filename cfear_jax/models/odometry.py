"""Keyframe odometry pipeline as a pure scan-carry state machine.

Fixed-shape re-design of `OdometryKeyframeFuser::processFrame`
(`odometrykeyframefuser.cpp:143-259`). The per-frame pipeline is a pure
function `step(state, polar_image) -> (state, FrameOutput)` run under
`jax.lax.scan` over frame chunks and `jax.vmap` over batches of sequences.

Numerical design: all on-device poses are ANCHOR-RELATIVE. Whenever a new
keyframe is fused the anchor is rebased to that keyframe's pose, so device
f32 coordinates stay within the submap extent (tens of meters, um-level
resolution) instead of growing with trajectory length (km). Each frame
output carries the pose in the pre-rebase anchor frame plus the anchor shift
applied that frame; the host composes the global f64 trajectory
(`compose_trajectory`).

The keyframe window is a fixed-size ring buffer of cell arrays
(`AddToReference`, `odometrykeyframefuser.cpp:470-476`), the keyframe gate is
1.5 m / 5 deg (`:62-73`), the initial guess is constant-velocity
(`:164-168`), motion compensation uses the previous frame's motion
(`:146-150`), and the velocity/acceleration sanity fallback reproduces
(`:76-94,197-199`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cfear_jax.config import CFEARConfig
from cfear_jax.ops import features, filtering, registration
from cfear_jax.ops.features import CellMap
from cfear_jax.utils import se2


class OdometryState(NamedTuple):
    """Scan-carry state (anchor-relative poses)."""

    kf_cells: CellMap      # (S, M, ...) keyframe cells, each in its local frame
    kf_poses: jax.Array    # (S, 3) keyframe poses in the anchor frame
    kf_valid: jax.Array    # (S,) bool
    t_prev: jax.Array      # (3,) previous frame pose in the anchor frame
    tmot: jax.Array        # (3,) previous frame-to-frame motion
    initialized: jax.Array # bool
    distance: jax.Array    # accumulated keyframe distance (m)
    frame_nr: jax.Array    # int32 — frames processed
    kf_count: jax.Array    # int32 — keyframes fused


class FrameOutput(NamedTuple):
    pose: jax.Array        # (3,) frame pose in the PRE-rebase anchor frame
    shift: jax.Array       # (3,) anchor rebase applied this frame (id if none)
    fused: jax.Array       # bool — became a keyframe
    cov: jax.Array         # (3, 3) registration covariance
    success: jax.Array     # bool
    score: jax.Array
    num_assoc: jax.Array
    num_cells: jax.Array
    reg_iterations: jax.Array
    # reverse-registration health signal (odometry.health_check_every):
    # checked=False frames carry (0, 0, healthy=True)
    health_checked: jax.Array  # bool
    healthy: jax.Array         # bool
    health_dist: jax.Array     # f32 m  — forward/backward discrepancy
    health_rot: jax.Array      # f32 rad


def _tree_select(pred, a, b):
    """jnp.where over matching pytrees with a scalar predicate."""
    return jax.tree.map(
        lambda x, y: jnp.where(jnp.reshape(pred, (1,) * x.ndim), x, y), a, b)


def init_state(cfg: CFEARConfig, dtype=jnp.float32) -> OdometryState:
    s = cfg.odometry.submap_scan_size
    m = cfg.feature.max_cells_raw if cfg.feature.use_raw_pointcloud \
        else cfg.feature.max_cells
    zeros_cells = CellMap(
        mean=jnp.zeros((s, m, 2), dtype),
        normal=jnp.zeros((s, m, 2), dtype),
        cov=jnp.zeros((s, m, 2, 2), dtype),
        nsamples=jnp.zeros((s, m), dtype),
        planarity=jnp.zeros((s, m), dtype),
        valid=jnp.zeros((s, m), bool),
    )
    return OdometryState(
        kf_cells=zeros_cells,
        kf_poses=jnp.zeros((s, 3), dtype),
        kf_valid=jnp.zeros((s,), bool),
        t_prev=jnp.zeros((3,), dtype),
        tmot=jnp.zeros((3,), dtype),
        initialized=jnp.asarray(False),
        distance=jnp.asarray(0.0, dtype),
        frame_nr=jnp.asarray(0, jnp.int32),
        kf_count=jnp.asarray(0, jnp.int32),
    )


def _push_keyframe(state: OdometryState, cells: CellMap, pose):
    """FIFO-push a keyframe and rebase the anchor to its pose."""
    rolled = jax.tree.map(lambda a: jnp.roll(a, -1, axis=0), state.kf_cells)
    new_cells = jax.tree.map(
        lambda buf, c: buf.at[-1].set(c), rolled, cells)
    inv = se2.inverse(pose)
    poses = jnp.roll(state.kf_poses, -1, axis=0).at[-1].set(pose)
    poses = se2.compose(inv[None, :], poses)        # rebase: new kf at identity
    valid = jnp.roll(state.kf_valid, -1, axis=0).at[-1].set(True)
    return new_cells, poses, valid


def _extract_cells(state: OdometryState, inp, cfg: CFEARConfig,
                   ingest: str = "image"):
    """Shared front half of the per-frame pipeline: filter + compensate +
    oriented surface points.

    `ingest="image"`: `inp` is the raw (A, R) uint8 polar sweep, filtered on
    device. `ingest="candidates"`: `inp` is a `filtering.Candidates` set
    pre-filtered by the host data plane (`native_io.filter_frames_host`) —
    identical downstream results, ~25x fewer bytes over the device link.
    `ingest="compact"`: `inp` is a `filtering.CompactCandidates` row set,
    additionally point-budget-compacted on the host — bit-identical
    downstream results, and the device-side budget sort is skipped."""
    # named scopes carry the reference's stage names ("Filtering"
    # `radar_driver.cpp:87`, "compensate"/"build_normals"
    # `odometrykeyframefuser.cpp:253-254`) into jax.profiler device traces
    with jax.named_scope("Filtering"):
        if ingest == "compact":
            pts = filtering.points_from_compact(inp, cfg)
        elif ingest == "candidates":
            pts = filtering.points_from_candidates(inp, cfg)
        else:
            pts = filtering.filter_polar_image(inp, cfg)
    # with time-continuous registration the velocity warp moves into the
    # solver (`register_time_continuous`), replacing the cloud-level
    # de-skew — applying both would compensate the distortion twice
    if cfg.odometry.compensate and not cfg.registration.time_continuous:
        with jax.named_scope("compensate"):
            xy = se2.compensate_points(pts.xy, state.tmot, cfg.radar.ccw)
            pts = pts._replace(xy=xy)
    with jax.named_scope("build_normals"):
        if cfg.feature.use_raw_pointcloud:
            return features.compute_raw_cells(pts, cfg)
        return features.compute_cells(pts, cfg)


def make_bootstrap(cfg: CFEARConfig, ingest: str = "image"):
    """First-frame initialization (`odometrykeyframefuser.cpp:171-177`),
    kept OUTSIDE the scanned step so the hot path carries no bootstrap
    branch (a vmapped lax.cond would execute both sides every frame)."""

    def bootstrap(state: OdometryState, image):
        cells = _extract_cells(state, image, cfg, ingest)
        ident = jnp.zeros((3,), state.t_prev.dtype)
        kfc, kfp, kfv = _push_keyframe(state, cells, ident)
        new_state = state._replace(
            kf_cells=kfc, kf_poses=kfp, kf_valid=kfv,
            t_prev=ident, initialized=jnp.asarray(True),
            frame_nr=state.frame_nr + 1, kf_count=jnp.asarray(1, jnp.int32))
        out = FrameOutput(
            pose=ident, shift=ident, fused=jnp.asarray(True),
            cov=jnp.eye(3, dtype=ident.dtype), success=jnp.asarray(True),
            score=jnp.asarray(0.0, ident.dtype),
            num_assoc=jnp.asarray(0, jnp.int32), num_cells=cells.n,
            reg_iterations=jnp.asarray(0, jnp.int32),
            health_checked=jnp.asarray(False), healthy=jnp.asarray(True),
            health_dist=jnp.asarray(0.0, ident.dtype),
            health_rot=jnp.asarray(0.0, ident.dtype))
        return new_state, out

    return bootstrap


def _fuse_frame(state: OdometryState, cells: CellMap, cfg: CFEARConfig
                ) -> tuple[OdometryState, FrameOutput]:
    """Back half of the per-frame pipeline: register the extracted cells
    against the keyframe window, apply sanity gates, fuse keyframes."""
    odo = cfg.odometry
    rot_gate = math.radians(odo.keyframe_min_rot_deg)
    dt = cfg.radar.sensor_period
    guess = se2.compose(state.t_prev, state.tmot) if odo.use_guess \
        else state.t_prev

    if cfg.registration.time_continuous:
        # time-continuous mode (`RegisterTimeContinuous`,
        # `n_scan_normal.cpp:67-80`): the velocity warp runs at CELL level
        # (`MapPointNormal::Compensate`, `pointnormal.cpp:113-133`) with
        # velocity = previous frame-to-frame motion, fixed during the
        # solve. Warping `cells` here before register() is exactly the
        # `register_time_continuous` library call, AND the warped cells
        # enter the keyframe window (mirroring the de-skewed clouds the
        # default cloud-level compensation path stores).
        with jax.named_scope("compensate"):
            cells = features.compensate_cells(cells, state.tmot,
                                              cfg.radar.ccw)
    with jax.named_scope("register"):
        res = registration.register(
            state.kf_cells, state.kf_poses, state.kf_valid, cells, guess,
            cfg=cfg)
    t_cur = jnp.where(res.success, res.pose, guess)
    # velocity / acceleration sanity fallback
    # (`odometrykeyframefuser.cpp:76-94,197-199`)
    tmot_cur = se2.relative(state.t_prev, t_cur)
    vel = jnp.linalg.norm(tmot_cur[:2]) / dt
    acc = jnp.linalg.norm(tmot_cur[:2] - state.tmot[:2]) / (dt * dt)
    sane = (vel <= odo.vel_limit) & (acc <= odo.acc_limit)
    t_cur = jnp.where(sane, t_cur, guess)
    tmot = se2.relative(state.t_prev, t_cur)

    cov = res.cov
    if odo.estimate_cov_by_sampling:
        # (`odometrykeyframefuser.cpp:203-208`): use the sampled
        # covariance when the quadratic fit is convex
        cov_s, convex = registration.sample_covariance(
            state.kf_cells, state.kf_poses, state.kf_valid, cells,
            t_cur, cfg)
        cov = jnp.where(convex, cov_s, cov)

    # --- reverse-registration health check (`health_check_every`) --------
    # Register the LAST KEYFRAME's cells against the current scan placed at
    # t_cur (the reverse problem, guess = the stored keyframe pose) and
    # measure the forward/backward discrepancy. A biased-but-"successful"
    # forward solve (the 12 m/s breaking regime: plentiful self-consistent
    # associations on motion-distorted scans) reverses to a DIFFERENT pose;
    # a healthy solve is consistent to ~cm. Runs every K frames via
    # lax.cond (a real branch in the single-sequence scan; under vmap both
    # sides execute — enable only where the cost is acceptable).
    if odo.health_check_every:
        # the reverse solve must ALWAYS register (a disable_registration
        # ablation would otherwise echo its guess and report healthy)
        import dataclasses as _dc
        cfg_rev = cfg.replace(registration=_dc.replace(
            cfg.registration, disable_registration=False))

        def _rev_check(_):
            kf1 = jax.tree.map(lambda a: a[None], cells)
            res_r = registration.register(
                kf1, t_cur[None], jnp.ones((1,), bool),
                jax.tree.map(lambda a: a[-1], state.kf_cells),
                state.kf_poses[-1], cfg=cfg_rev)
            d = se2.relative(state.kf_poses[-1], res_r.pose)
            return (jnp.linalg.norm(d[:2]),
                    jnp.abs(se2.normalize_angle(d[2])), res_r.success)

        def _skip(_):
            z = jnp.asarray(0.0, t_cur.dtype)
            return z, z, jnp.asarray(True)

        checked = ((state.frame_nr % odo.health_check_every) == 0) \
            & state.kf_valid[-1]
        h_dist, h_rot, rev_ok = jax.lax.cond(checked, _rev_check, _skip,
                                             None)
        # a failed/collapsed reverse solve echoes its guess (d == 0), so
        # the discrepancy thresholds alone would report exactly the
        # most-degraded frames healthy — a checked frame is healthy only
        # if the reverse solve SUCCEEDED and agreed
        healthy = (~checked) | (
            rev_ok
            & (h_dist <= odo.health_max_dist)
            & (h_rot <= math.radians(odo.health_max_rot_deg)))
    else:
        checked = jnp.asarray(False)
        healthy = jnp.asarray(True)
        h_dist = jnp.asarray(0.0, t_cur.dtype)
        h_rot = jnp.asarray(0.0, t_cur.dtype)

    keydiff = se2.relative(state.kf_poses[-1], t_cur)
    fuse = (jnp.linalg.norm(keydiff[:2]) > odo.keyframe_min_dist) \
        | (jnp.abs(se2.normalize_angle(keydiff[2])) > rot_gate)
    fuse = fuse | jnp.logical_not(odo.use_keyframe)
    fuse = fuse & res.success

    kfc, kfp, kfv = _push_keyframe(state, cells, t_cur)
    fused_state = state._replace(
        kf_cells=kfc, kf_poses=kfp, kf_valid=kfv,
        t_prev=jnp.zeros((3,), guess.dtype),   # rebased
        tmot=tmot,
        distance=state.distance + jnp.linalg.norm(keydiff[:2]),
        frame_nr=state.frame_nr + 1,
        kf_count=state.kf_count + 1)
    plain_state = state._replace(
        t_prev=t_cur, tmot=tmot, frame_nr=state.frame_nr + 1)
    new_state = _tree_select(fuse, fused_state, plain_state)
    out = FrameOutput(
        pose=t_cur,
        shift=jnp.where(fuse, t_cur, jnp.zeros_like(t_cur)),
        fused=fuse, cov=cov, success=res.success,
        score=res.score, num_assoc=res.num_assoc, num_cells=cells.n,
        reg_iterations=res.iterations,
        health_checked=checked, healthy=healthy,
        health_dist=h_dist, health_rot=h_rot)
    return new_state, out


def make_step(cfg: CFEARConfig, ingest: str = "image"):
    """Build the jittable per-frame step function for a config.

    The state MUST be initialized (make_bootstrap) before stepping."""

    def step(state: OdometryState, image) -> tuple[OdometryState, FrameOutput]:
        cells = _extract_cells(state, image, cfg, ingest)
        return _fuse_frame(state, cells, cfg)

    return step


def make_batched_step(cfg: CFEARConfig, ingest: str = "image"):
    """Per-frame step over a BATCH of sequences: semantically identical to
    `jax.vmap(make_step(cfg, ingest))`, but the feature stage runs the
    hand-batched `compute_cells_batched` — XLA serializes vmapped
    scatters/gathers lane by lane, which flattens batched throughput (the
    bash process fleet of SURVEY.md §2.3 maps to many sequences per chip,
    so the batched step IS the throughput path)."""
    from cfear_jax.ops import filtering

    def stepb(states: OdometryState, inputs
              ) -> tuple[OdometryState, FrameOutput]:
        if ingest == "compact":
            pts = jax.vmap(
                lambda c: filtering.points_from_compact(c, cfg))(inputs)
        elif ingest == "candidates":
            pts = jax.vmap(
                lambda c: filtering.points_from_candidates(c, cfg))(inputs)
        else:
            pts = jax.vmap(
                lambda im: filtering.filter_polar_image(im, cfg))(inputs)
        if cfg.odometry.compensate:
            xy = jax.vmap(
                lambda p, t: se2.compensate_points(p, t, cfg.radar.ccw))(
                    pts.xy, states.tmot)
            pts = pts._replace(xy=xy)
        if cfg.feature.use_raw_pointcloud:
            cells = jax.vmap(
                lambda p: features.compute_raw_cells(p, cfg))(pts)
        else:
            cells = features.compute_cells_batched(pts, cfg)
        cfg_lane = registration.for_lanes(cfg, cells.valid.shape[0])
        return jax.vmap(lambda s, c: _fuse_frame(s, c, cfg_lane))(states,
                                                                   cells)

    return stepb


def make_chunk_runner(cfg: CFEARConfig, ingest: str = "image"):
    """jit-compiled scan over a chunk of frames: (state, (T,A,R)) -> ..."""
    step = make_step(cfg, ingest)

    @jax.jit
    def run_chunk(state: OdometryState, images):
        return jax.lax.scan(step, state, images)

    return run_chunk


def compose_trajectory(outputs: FrameOutput) -> np.ndarray:
    """Host-side f64 reconstruction of global poses from anchor-relative
    frame outputs. Returns (T, 3) [x, y, theta] in the world frame."""
    pose = np.asarray(outputs.pose, np.float64)
    shift = np.asarray(outputs.shift, np.float64)
    fused = np.asarray(outputs.fused)
    t = pose.shape[0]
    world = np.zeros((t, 3))
    anchor = np.zeros(3)

    def comp(a, b):
        c, s = math.cos(a[2]), math.sin(a[2])
        return np.array([a[0] + c * b[0] - s * b[1],
                         a[1] + s * b[0] + c * b[1],
                         a[2] + b[2]])

    for i in range(t):
        world[i] = comp(anchor, pose[i])
        if fused[i]:
            anchor = comp(anchor, shift[i])
    return world


class OdometryRunner:
    """Host-side sequence driver: streams polar images through jitted chunks.

    Equivalent of the offline rosbag loop (`offline_odometry.cpp:98-126`)
    without ROS: feed uint8 polar frames, get a global f64 trajectory.
    """

    def __init__(self, cfg: CFEARConfig, chunk: int = 16, dtype=jnp.float32,
                 ingest: str = "image"):
        """`ingest="image"`: raw sweeps go to the device and are filtered
        there. `ingest="host"`: the native data plane runs the k-strongest
        filter on host CPU threads and only the (A, K) candidate sets cross
        the host->device link (identical results; much less link traffic)."""
        self.cfg = cfg
        self.chunk = chunk
        self.ingest = ingest
        kind = "image"
        if ingest == "host":
            # the k-strongest path with a point budget uses the fully
            # compacted row ingest (bit-identical results, no device sort)
            kind = ("compact" if cfg.filter.method != "cacfar"
                    and cfg.feature.point_budget else "candidates")
        self.run_chunk = make_chunk_runner(cfg, kind)
        self.step = jax.jit(make_step(cfg, kind))
        self.bootstrap = jax.jit(make_bootstrap(cfg, kind))
        self.state = init_state(cfg, dtype)
        self.outputs: list = []

    def _prepare(self, images: np.ndarray):
        """Raw (T, A, R) frames -> per-frame device inputs."""
        if self.ingest != "host":
            return images
        from cfear_jax.ops.filtering import (
            Candidates, CompactCandidates)
        from cfear_jax.utils import native_io
        if self.cfg.filter.method == "cacfar":
            b, i, p = native_io.cfar_filter_frames_host(images, self.cfg)
        elif self.cfg.feature.point_budget:
            f, radar = self.cfg.filter, self.cfg.radar
            min_bin = int(math.ceil(radar.min_distance / radar.range_res))
            b, a, i, p = native_io.filter_frames_host_compact(
                images, f.k_strongest, f.z_min, f.nms_window,
                self.cfg.feature.point_budget, min_bin,
                z_quantile=f.z_min_quantile)
            return CompactCandidates(bins=b, azimuth=a, intensity=i, peak=p)
        else:
            b, i, p = native_io.filter_frames_host(
                images, self.cfg.filter.k_strongest, self.cfg.filter.z_min,
                self.cfg.filter.nms_window,
                z_quantile=self.cfg.filter.z_min_quantile)
        return Candidates(bins=b, intensity=i, peak=p)

    def process(self, images: np.ndarray) -> None:
        """Process (T, A, R) uint8 frames (T need not be chunk-aligned)."""
        t = images.shape[0]

        def part(lo, hi):
            # host ingest: the native filter runs HERE — on the caller's
            # thread (the feeder), per chunk — so filtering chunk i+1
            # overlaps the device compute of chunk i. (It used to run for
            # ALL frames up front inside _prepare, serializing the whole
            # host filter phase before the first chunk could start.)
            return jax.tree.map(jnp.asarray, self._prepare(images[lo:hi]))

        def frame(i):
            return jax.tree.map(lambda x: x[0], part(i, i + 1))

        start = 0
        if t and not bool(self.state.initialized):
            self.state, out0 = self.bootstrap(self.state, frame(0))
            self.outputs.append(jax.tree.map(lambda a: a[None], out0))
            start = 1
        n_full = start + ((t - start) // self.chunk) * self.chunk
        # Streaming discipline (the bench pipeline, built in):
        # - the FEEDER THREAD filters (host ingest) and uploads chunk i+1
        #   while the device runs chunk i (the native filter call releases
        #   the GIL and fans out over host cores itself);
        # - chunk outputs stay ON DEVICE until trajectory()/frame_outputs()
        #   (a per-chunk fetch would sync the dispatch pipeline and pay a
        #   device-to-host round-trip once per leaf per chunk); everything
        #   returns in one stacked transfer.
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=2)

        def feeder():
            for i in range(start, n_full, self.chunk):
                q.put(part(i, i + self.chunk))
            q.put(None)

        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        while True:
            dev_in = q.get()
            if dev_in is None:
                break
            self.state, out = self.run_chunk(self.state, dev_in)
            self.outputs.append(out)
        th.join()
        for i in range(n_full, t):  # ragged tail: single jitted steps
            self.state, out = self.step(self.state, frame(i))
            self.outputs.append(jax.tree.map(lambda a: a[None], out))

    def _materialize(self) -> None:
        # concatenate per-chunk outputs ON DEVICE first, then fetch each
        # leaf ONCE instead of paying one device-to-host transfer per leaf
        # per chunk. Only the DEVICE-RESIDENT suffix is
        # stacked — already-materialized numpy outputs (earlier calls, the
        # online daemon's incremental polls, resume()) must not round-trip
        # back through the device.
        split = next((i for i, o in enumerate(self.outputs)
                      if not isinstance(jax.tree.leaves(o)[0], np.ndarray)),
                     len(self.outputs))
        head, tail = self.outputs[:split], self.outputs[split:]
        if len(tail) > 1:
            stacked = jax.tree.map(lambda *xs: jnp.concatenate(xs), *tail)
            tail = [jax.tree.map(np.asarray, stacked)]
        elif tail:
            tail = [jax.tree.map(np.asarray, tail[0])]
        self.outputs = head + tail

    def trajectory(self) -> np.ndarray:
        self._materialize()
        out = jax.tree.map(lambda *xs: np.concatenate(xs), *self.outputs)
        self._last = out
        return compose_trajectory(out)

    def frame_outputs(self) -> FrameOutput:
        self._materialize()
        return jax.tree.map(lambda *xs: np.concatenate(xs), *self.outputs)

    def reset(self, dtype=jnp.float32) -> None:
        """Reinitialize the scan-carry state and drop accumulated outputs,
        KEEPING the jitted executables. Use for timed re-passes: a fresh
        OdometryRunner builds new jit wrappers and compiles again."""
        self.state = init_state(self.cfg, dtype)
        self.outputs = []

    # -- checkpoint / resume (SURVEY.md §5: the reference only saves its
    # graph at exit; here the full scan-carry state is restorable) ---------
    def save_checkpoint(self, path: str) -> None:
        leaves, _ = jax.tree.flatten(self.state)
        payload = {f"state_{i}": np.asarray(l) for i, l in enumerate(leaves)}
        if self.outputs:
            out = self.frame_outputs()
            payload.update({f"out_{k}": np.asarray(v)
                            for k, v in out._asdict().items()})
        np.savez_compressed(path, **payload)

    @classmethod
    def resume(cls, cfg: CFEARConfig, path: str, chunk: int = 16,
               ingest: str = "image") -> "OdometryRunner":
        runner = cls(cfg, chunk=chunk, ingest=ingest)
        z = np.load(path)
        leaves, treedef = jax.tree.flatten(runner.state)
        new_leaves = [jnp.asarray(z[f"state_{i}"]).astype(l.dtype)
                      for i, l in enumerate(leaves)]
        runner.state = jax.tree.unflatten(treedef, new_leaves)
        if "out_pose" in z:
            t = z["out_pose"].shape[0]
            # health fields may be absent in checkpoints written before
            # the reverse-registration health signal existed
            defaults = {"health_checked": np.zeros((t,), bool),
                        "healthy": np.ones((t,), bool),
                        "health_dist": np.zeros((t,), np.float32),
                        "health_rot": np.zeros((t,), np.float32)}
            out = FrameOutput(**{
                k: (z[f"out_{k}"] if f"out_{k}" in z.files else defaults[k])
                for k in FrameOutput._fields})
            runner.outputs = [out]
        return runner
