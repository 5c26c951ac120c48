import numpy as np

from cfear_jax.utils import native_io


def _frames(n, a=64, r=128, seed=0):
    rng = np.random.default_rng(seed)
    return [(i * 0.25, rng.integers(0, 255, (a, r), dtype=np.uint8))
            for i in range(n)]


def test_native_lib_builds():
    assert native_io.native_available(), \
        "g++ toolchain present but native lib failed to build"


def test_pack_roundtrip(tmp_path):
    path = str(tmp_path / "seq.rpk")
    frames = _frames(10)
    native_io.pack_frames(path, iter(frames), len(frames))
    pack = native_io.RadarPack(path)
    assert (pack.n_frames, pack.n_azimuths, pack.n_bins) == (10, 64, 128)
    for i in (0, 5, 9):
        stamp, img = pack.read(i)
        assert abs(stamp - frames[i][0]) < 1e-6
        np.testing.assert_array_equal(img, frames[i][1])
    pack.close()


def test_prefetch_loader_streams_all(tmp_path):
    path = str(tmp_path / "seq.rpk")
    frames = _frames(23, seed=1)
    native_io.pack_frames(path, iter(frames), len(frames))
    pack = native_io.RadarPack(path)
    loader = native_io.PrefetchLoader(pack, batch=8, depth=2)
    got = []
    while True:
        nxt = loader.next()
        if nxt is None:
            break
        data, stamps, first = nxt
        assert first == len(got)
        got.extend(list(data))
    assert len(got) == 23
    np.testing.assert_array_equal(got[22], frames[22][1])
    np.testing.assert_array_equal(got[0], frames[0][1])
    loader.close()
    pack.close()


def test_loader_loop_mode(tmp_path):
    path = str(tmp_path / "seq.rpk")
    frames = _frames(4, seed=2)
    native_io.pack_frames(path, iter(frames), len(frames))
    pack = native_io.RadarPack(path)
    loader = native_io.PrefetchLoader(pack, batch=4, depth=2, loop=True)
    for _ in range(3):           # endless stream keeps producing
        nxt = loader.next()
        assert nxt is not None
        assert nxt[0].shape[0] == 4
    loader.close()
    pack.close()


def test_host_filter_matches_device_filter():
    """Native k-strongest+NMS must be bit-identical to ops/filtering.py."""
    import jax.numpy as jnp

    from cfear_jax.config import preset
    from cfear_jax.ops import filtering

    cfg = preset("CFEAR-1", dataset="synthetic")
    rng = np.random.default_rng(7)
    a, r = cfg.radar.n_azimuths, cfg.radar.n_bins
    # include flat/tied regions to exercise the tie-break
    img = rng.integers(0, 255, (a, r), dtype=np.uint8)
    img[:, 100:110] = 200
    k, z = cfg.filter.k_strongest, cfg.filter.z_min
    bins_h, int_h, peak_h = native_io.filter_frames_host(
        img, k, z, cfg.filter.nms_window)
    bins_d, valid_d = filtering.kstrongest_mask(jnp.asarray(img), k, z)
    peak_img = filtering.nms_peak_image(jnp.asarray(img), cfg.filter.nms_window)
    peaks_d = jnp.take_along_axis(peak_img, bins_d, axis=1) & valid_d
    np.testing.assert_array_equal(
        bins_h, np.where(np.asarray(valid_d), np.asarray(bins_d), -1))
    np.testing.assert_array_equal(
        int_h, np.where(np.asarray(valid_d),
                        np.take_along_axis(img, np.asarray(bins_d), axis=1), 0))
    np.testing.assert_array_equal(peak_h.astype(bool), np.asarray(peaks_d))


def test_host_filter_native_matches_numpy_fallback():
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 255, (3, 32, 256), dtype=np.uint8)
    b1 = np.empty((3, 32, 9), np.int16)
    i1 = np.empty((3, 32, 9), np.uint8)
    p1 = np.empty((3, 32, 9), np.uint8)
    native_io._filter_frames_numpy(imgs, 9, 60, 3, b1, i1, p1)
    b2, i2, p2 = native_io.filter_frames_host(imgs, 9, 60, 3)
    np.testing.assert_array_equal(b1, b2)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(p1, p2)


def test_budget_compact_matches_device_selection_order():
    """Host compaction must reproduce the device point_budget selection:
    (intensity desc, flat azimuth-major index asc) among range-gated
    candidates — set AND order (`ops/features.py` stable argsort)."""
    rng = np.random.default_rng(3)
    t, a, k, p, min_bin = 4, 32, 12, 96, 5
    bins = rng.integers(-1, 128, (t, a, k)).astype(np.int16)
    intens = rng.integers(0, 90, (t, a, k), dtype=np.uint8)  # many ties
    peaks = rng.integers(0, 2, (t, a, k), dtype=np.uint8)
    ob, oa, oi, op = native_io.budget_compact_host(bins, intens, peaks,
                                                   p, min_bin)
    # oracle: the device-side formulation
    gate = bins > min_bin
    key = np.where(gate, intens.astype(np.int32), -1).reshape(t, a * k)
    order = np.argsort(-key, axis=-1, kind="stable")[:, :p]
    sel = np.take_along_axis(key, order, axis=-1)
    valid = sel >= 0
    np.testing.assert_array_equal(
        ob, np.where(valid, np.take_along_axis(
            bins.reshape(t, -1), order, -1), -1))
    np.testing.assert_array_equal(
        oa, np.where(valid, order // k, 0))
    np.testing.assert_array_equal(
        oi, np.where(valid, np.take_along_axis(
            intens.reshape(t, -1), order, -1), 0))
    np.testing.assert_array_equal(
        op, np.where(valid, np.take_along_axis(
            peaks.reshape(t, -1), order, -1), 0))


def test_budget_compact_native_matches_numpy_fallback():
    rng = np.random.default_rng(5)
    t, a, k, p, min_bin = 3, 16, 8, 40, 2
    bins = rng.integers(-1, 64, (t, a, k)).astype(np.int16)
    intens = rng.integers(0, 255, (t, a, k), dtype=np.uint8)
    peaks = rng.integers(0, 2, (t, a, k), dtype=np.uint8)
    ob1 = np.empty((t, p), np.int16)
    oa1 = np.empty((t, p), np.int16)
    oi1 = np.empty((t, p), np.uint8)
    op1 = np.empty((t, p), np.uint8)
    native_io._budget_compact_numpy(bins, intens, peaks, p, min_bin,
                                    ob1, oa1, oi1, op1)
    ob2, oa2, oi2, op2 = native_io.budget_compact_host(bins, intens, peaks,
                                                       p, min_bin)
    np.testing.assert_array_equal(ob1, ob2)
    np.testing.assert_array_equal(oa1, oa2)
    np.testing.assert_array_equal(oi1, oi2)
    np.testing.assert_array_equal(op1, op2)


def test_compact_pipeline_matches_image_pipeline():
    """Compacted host ingest (point_budget rows) must select the EXACT same
    candidate rows, in the same order, as on-device filtering + on-device
    budget compaction — and produce the same odometry.

    The candidate contract is exact (bit-for-bit set and order equality),
    checked against the ACTUAL device compaction (`features.budget_points`)
    so the host twin cannot silently diverge if the overflow policy changes.
    The odometry comparison checks PER-FRAME pose deltas (accumulation
    cannot hide a divergent frame): the two ingests run through two
    separately compiled XLA programs (different input shapes -> different
    fusion/FMA-contraction choices), so identical candidates still yield
    last-ulp cost differences, and the LM solver's data-dependent stopping
    (function_tolerance=1e-4 on relative cost decrease) turns those into
    different iteration counts — measured up to ~2.5e-3 m per-frame pose
    difference on CPU. The bound is set by that solver tolerance, not by
    transfer precision; a state-handling bug (wrong keyframe window, stale
    tmot) shifts deltas by centimeters and fails it."""
    import dataclasses
    import math

    import jax.numpy as jnp

    from cfear_jax.config import preset
    from cfear_jax.datasets import synthetic
    from cfear_jax.models.odometry import (
        OdometryRunner)
    from cfear_jax.ops import features, filtering

    cfg = preset("CFEAR-3", dataset="synthetic")
    cfg = cfg.replace(feature=dataclasses.replace(cfg.feature,
                                                  point_budget=512))
    images, _ = synthetic.make_sequence(seed=23, n_frames=10, cfg=cfg)

    # exact contract: host compaction == device filter + device compaction
    # (pd_c below IS the production compaction, not a re-implementation)
    f, radar, pb = cfg.filter, cfg.radar, cfg.feature.point_budget
    min_bin = int(math.ceil(radar.min_distance / radar.range_res))
    b, a, i, p = native_io.filter_frames_host_compact(
        images, f.k_strongest, f.z_min, f.nms_window, pb, min_bin)
    for t in range(len(images)):
        cc = filtering.CompactCandidates(bins=b[t], azimuth=a[t],
                                         intensity=i[t], peak=p[t])
        ph = filtering.points_from_compact(cc, cfg)
        pd = filtering.filter_polar_image(jnp.asarray(images[t]), cfg)
        pd_c = features.budget_points(pd, pb)
        vh = np.asarray(ph.valid)
        vd = np.asarray(pd_c.valid)
        assert vh.sum() == vd.sum()
        np.testing.assert_array_equal(np.asarray(ph.xy)[vh],
                                      np.asarray(pd_c.xy)[vd])
        np.testing.assert_array_equal(np.asarray(ph.intensity)[vh],
                                      np.asarray(pd_c.intensity)[vd])
        np.testing.assert_array_equal(np.asarray(ph.peak)[vh],
                                      np.asarray(pd_c.peak)[vd])

    r_img = OdometryRunner(cfg, chunk=4, ingest="image")
    r_img.process(images)
    r_host = OdometryRunner(cfg, chunk=4, ingest="host")
    assert r_host.run_chunk is not r_img.run_chunk
    r_host.process(images)
    t_img = r_img.trajectory()
    t_host = r_host.trajectory()
    # per-frame deltas at solver-tolerance level (see docstring)
    np.testing.assert_allclose(np.diff(t_img, axis=0),
                               np.diff(t_host, axis=0), atol=5e-3)
    np.testing.assert_allclose(t_img, t_host, atol=1e-2)


def test_candidates_pipeline_matches_image_pipeline():
    """Host-filter ingest must produce identical odometry to image ingest."""
    from cfear_jax.config import preset
    from cfear_jax.datasets import synthetic
    from cfear_jax.models.odometry import (
        OdometryRunner)

    cfg = preset("CFEAR-3", dataset="synthetic")
    images, _ = synthetic.make_sequence(seed=21, n_frames=10, cfg=cfg)
    r_img = OdometryRunner(cfg, chunk=4, ingest="image")
    r_img.process(images)
    r_host = OdometryRunner(cfg, chunk=4, ingest="host")
    r_host.process(images)
    np.testing.assert_allclose(r_img.trajectory(), r_host.trajectory(),
                               atol=1e-6)
