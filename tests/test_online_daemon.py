"""Online streaming daemon (`cfear_radarodometry_node` equivalent):
follow a growing radar pack, emit poses incrementally, match offline."""

import dataclasses
import threading
import time

import numpy as np

from cfear_jax.config import preset
from cfear_jax.datasets import synthetic
from cfear_jax.models import odometry
from cfear_jax.online_odometry import (
    OnlineOdometry, PackFollower)
from cfear_jax.utils import native_io


def _cfg():
    cfg = preset("CFEAR-3", dataset="synthetic")
    return cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=256),
        filter=dataclasses.replace(cfg.filter, k_strongest=8))


def _write_header(path, a, r):
    hdr = np.array([0x5241444152504B31, 0, a, r], np.uint64)
    with open(path, "wb") as f:
        f.write(hdr.tobytes())


def _append_frame(path, stamp_s, img):
    with open(path, "ab") as f:
        f.write(np.uint64(int(stamp_s * 1e9)).tobytes())
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def test_follow_growing_pack_matches_offline(tmp_path):
    """A recorder thread appends sweeps while the daemon follows: the
    streamed trajectory must equal the offline batch run, and every pose
    must be emitted to the TUM output."""
    cfg = _cfg()
    n = 24
    images, _ = synthetic.make_sequence(seed=31, n_frames=n, cfg=cfg,
                                        speed=5.0)
    pack = str(tmp_path / "live.radarpack")
    out = str(tmp_path / "poses.tum")
    _write_header(pack, images.shape[1], images.shape[2])

    def recorder():
        for i in range(n):
            _append_frame(pack, i * cfg.radar.sensor_period, images[i])
            time.sleep(0.03)           # ~8x real-time recorder

    th = threading.Thread(target=recorder, daemon=True)
    th.start()
    daemon = OnlineOdometry(cfg, pack, out, chunk=4, ingest="host",
                            poll_s=0.02)
    processed = daemon.run(follow=True, idle_timeout_s=8.0)
    th.join()
    assert processed == n

    lines = open(out).read().strip().splitlines()
    assert len(lines) == n
    streamed = np.array([[float(v) for v in ln.split()] for ln in lines])
    assert np.all(np.diff(streamed[:, 0]) > 0)       # monotonic stamps

    offline = odometry.OdometryRunner(cfg, chunk=4, ingest="host")
    offline.process(images)
    ref = offline.trajectory()
    # same pipeline, same ingest; chunk partitioning may differ (the daemon
    # processes ragged batches as data arrives) -> solver-tolerance level
    np.testing.assert_allclose(daemon.trajectory()[:, :2], ref[:, :2],
                               atol=2e-2)
    np.testing.assert_allclose(streamed[:, 1:3], ref[:, :2], atol=2e-2)


def test_drain_mode_without_follow(tmp_path):
    """Single-pass mode: drain a finished pack (written via the native
    writer) and exit without waiting for the idle timeout."""
    cfg = _cfg()
    n = 8
    images, _ = synthetic.make_sequence(seed=32, n_frames=n, cfg=cfg)
    pack = str(tmp_path / "done.radarpack")
    native_io.pack_frames(
        pack, ((i * 0.25, images[i]) for i in range(n)), n)

    out = str(tmp_path / "poses.tum")
    t0 = time.time()
    daemon = OnlineOdometry(cfg, pack, out, chunk=4, ingest="host")
    processed = daemon.run(follow=False)
    assert processed == n
    assert time.time() - t0 < 60.0
    assert len(open(out).read().strip().splitlines()) == n


def test_pack_follower_ignores_partial_records(tmp_path):
    """A partially written trailing record must not surface as a frame."""
    a, r = 16, 32
    pack = str(tmp_path / "partial.radarpack")
    _write_header(pack, a, r)
    img = np.arange(a * r, dtype=np.uint8).reshape(a, r)
    _append_frame(pack, 1.0, img)
    with open(pack, "ab") as f:          # half a record
        f.write(b"\x00" * ((8 + a * r) // 2))
    fl = PackFollower(pack)
    frames, stamps = fl.read_new()
    assert len(frames) == 1
    np.testing.assert_array_equal(frames[0], img)
    assert fl.read_new() is None


def test_live_viz_follows_daemon_output(tmp_path):
    """Integration of the live surface: a recorder thread grows the radar
    pack, the online daemon follows it appending TUM poses, and the live
    viewer (`eval/live_viz.py`, the RViz-follower equivalent) picks the
    poses up incrementally and renders snapshots — the full reference
    online topology (radar topic -> odometry node -> RViz) as files."""
    from cfear_jax.eval import live_viz

    cfg = _cfg()
    images, _ = synthetic.make_sequence(seed=13, n_frames=14, cfg=cfg,
                                        speed=6.0)
    pack = str(tmp_path / "run.radarpack")
    tum = str(tmp_path / "poses.tum")
    png = str(tmp_path / "live.png")
    a, r = images.shape[1], images.shape[2]
    _write_header(pack, a, r)
    for i in range(6):
        _append_frame(pack, i * 0.25, images[i])

    def recorder():
        for i in range(6, len(images)):
            time.sleep(0.15)
            _append_frame(pack, i * 0.25, images[i])

    th = threading.Thread(target=recorder, daemon=True)
    th.start()
    # drive the daemon in-process (the CLI does not expose the shrunken
    # test config; OnlineOdometry is the daemon's engine)
    daemon = OnlineOdometry(cfg, pack, tum, chunk=4, ingest="host")
    daemon.run(follow=True, idle_timeout_s=3.0)
    th.join()

    fol = live_viz.TumFollower(tum)
    n1 = fol.poll()
    assert n1 == len(images), n1
    live_viz.render_snapshot(png, fol.poses)
    import os as _os
    assert _os.path.getsize(png) > 0
