import numpy as np
import jax.numpy as jnp

from cfear_jax.config import preset
from cfear_jax.ops import filtering

from oracles import kstrongest_oracle, nms_peaks_oracle, points_oracle


def _cfg(k=8, z_min=60, n_az=64, n_bins=256):
    cfg = preset("CFEAR-3", dataset="synthetic")
    import dataclasses
    radar = dataclasses.replace(cfg.radar, n_azimuths=n_az, n_bins=n_bins,
                                range_res=0.5)
    filt = dataclasses.replace(cfg.filter, k_strongest=k, z_min=z_min)
    return cfg.replace(radar=radar, filter=filt)


def rand_image(rng, a, r):
    img = rng.integers(0, 80, (a, r), dtype=np.int64)
    # sprinkle strong returns
    for _ in range(a * 4):
        az, b = rng.integers(0, a), rng.integers(0, r)
        img[az, b] = rng.integers(60, 256)
    return np.clip(img, 0, 255).astype(np.uint8)


def test_kstrongest_matches_oracle():
    rng = np.random.default_rng(0)
    cfg = _cfg()
    img = rand_image(rng, 64, 256)
    bins, valid = filtering.kstrongest_mask(jnp.asarray(img),
                                            cfg.filter.k_strongest,
                                            cfg.filter.z_min)
    bins, valid = np.asarray(bins), np.asarray(valid)
    expect = kstrongest_oracle(img, cfg.filter.k_strongest, cfg.filter.z_min)
    for az in range(64):
        got = sorted(bins[az][valid[az]].tolist())
        assert got == expect[az], f"azimuth {az}"


def test_kstrongest_tie_break_prefers_larger_bin():
    cfg = _cfg(k=2, z_min=60)
    img = np.zeros((64, 256), np.uint8)
    img[0, [10, 20, 30]] = 100          # three equal: keep the two largest bins
    bins, valid = filtering.kstrongest_mask(jnp.asarray(img), 2, 60)
    got = sorted(np.asarray(bins)[0][np.asarray(valid)[0]].tolist())
    assert got == [20, 30]


def test_nms_peaks_match_oracle():
    rng = np.random.default_rng(1)
    cfg = _cfg()
    img = rand_image(rng, 64, 256)
    k, z = cfg.filter.k_strongest, cfg.filter.z_min
    bins, valid = filtering.kstrongest_mask(jnp.asarray(img), k, z)
    peak_img = np.asarray(filtering.nms_peak_image(jnp.asarray(img), 3))
    kept = kstrongest_oracle(img, k, z)
    expect = nms_peaks_oracle(img, kept, 3)
    bins, valid = np.asarray(bins), np.asarray(valid)
    for az in range(64):
        got = sorted(b for b, v in zip(bins[az], valid[az])
                     if v and peak_img[az, b])
        assert got == expect[az], f"azimuth {az}"


def test_full_filter_points_match_oracle():
    rng = np.random.default_rng(2)
    cfg = _cfg()
    img = rand_image(rng, 64, 256)
    pc = filtering.filter_polar_image(jnp.asarray(img), cfg)
    xy = np.asarray(pc.xy)[np.asarray(pc.valid)]
    inten = np.asarray(pc.intensity)[np.asarray(pc.valid)]
    kept = kstrongest_oracle(img, cfg.filter.k_strongest, cfg.filter.z_min)
    expect = points_oracle(img, kept, cfg.radar.range_res,
                           cfg.radar.min_distance)
    got = np.stack([xy[:, 0], xy[:, 1], inten], -1)

    def canon(a):  # stable sort on rounded keys to tolerate f32 jitter
        key = np.round(a, 3)
        return a[np.lexsort((key[:, 2], key[:, 1], key[:, 0]))]

    got_sorted, exp_sorted = canon(got), canon(expect)
    assert got_sorted.shape == exp_sorted.shape
    np.testing.assert_allclose(got_sorted, exp_sorted, atol=2e-3)


def test_cacfar_borders_no_detection():
    cfg = _cfg()
    import dataclasses
    filt = dataclasses.replace(cfg.filter, method="cacfar", cfar_window=8,
                               cfar_guard=2)
    cfg = cfg.replace(filter=filt)
    img = np.full((64, 256), 200, np.uint8)   # uniform -> no CFAR exceedance
    mask = np.asarray(filtering.cacfar_mask(jnp.asarray(img), cfg))
    assert not mask.any()
    # isolated strong point in noise floor -> detected
    img2 = np.full((64, 256), 10, np.uint8)
    img2[5, 100] = 250
    mask2 = np.asarray(filtering.cacfar_mask(jnp.asarray(img2), cfg))
    assert mask2[5, 100]
    assert mask2.sum() == 1


def _cfar_cfg(n_az=64, n_bins=256, kc=50):
    import dataclasses
    cfg = _cfg()
    filt = dataclasses.replace(cfg.filter, method="cacfar", cfar_window=8,
                               cfar_guard=2, cfar_max_per_azimuth=kc)
    return cfg.replace(filter=filt)


def test_cacfar_exclusive_matches_reference_oracle():
    """filter_polar_image(method="cacfar") == a literal double-precision
    restatement of `cfar.cpp:35-71` (exclusive dispatch,
    `radar_driver.cpp:52-57`): same point set, range = bin*dr, no peaks."""
    from oracles import cacfar_oracle
    rng = np.random.default_rng(3)
    cfg = _cfar_cfg()
    img = rand_image(rng, 64, 256)
    f, radar = cfg.filter, cfg.radar
    expect = cacfar_oracle(img, f.cfar_window, f.cfar_guard,
                           f.false_alarm_rate, radar.range_res,
                           f.static_threshold, radar.min_distance,
                           f.cfar_max_distance)
    pc = filtering.filter_polar_image(jnp.asarray(img), cfg)
    valid = np.asarray(pc.valid)
    assert not np.asarray(pc.peak).any()      # no peaks cloud on CFAR path
    got = np.concatenate([np.asarray(pc.xy)[valid],
                          np.asarray(pc.intensity)[valid][:, None]], -1)

    def canon(a):
        key = np.round(a, 3)
        return a[np.lexsort((key[:, 2], key[:, 1], key[:, 0]))]

    assert got.shape == expect.shape
    np.testing.assert_allclose(canon(got), canon(expect), atol=2e-3)


def test_cacfar_host_ingest_matches_device():
    """Native/NumPy host CFAR filter == device cfar_select, bit-exactly,
    and points_from_candidates == filter_polar_image on the CFAR path."""
    from cfear_jax.utils import native_io
    rng = np.random.default_rng(4)
    cfg = _cfar_cfg()
    imgs = np.stack([rand_image(rng, 64, 256) for _ in range(3)])
    bins_h, int_h, peak_h = native_io.cfar_filter_frames_host(imgs, cfg)
    assert not peak_h.any()
    for t in range(imgs.shape[0]):
        bins_d, valid_d, int_d = filtering.cfar_select(
            jnp.asarray(imgs[t]), cfg)
        bins_d = np.where(np.asarray(valid_d), np.asarray(bins_d), -1)
        np.testing.assert_array_equal(bins_h[t], bins_d.astype(np.int16))
        np.testing.assert_array_equal(
            int_h[t], np.where(np.asarray(valid_d), np.asarray(int_d), 0))
        pc_dev = filtering.filter_polar_image(jnp.asarray(imgs[t]), cfg)
        pc_cand = filtering.points_from_candidates(
            filtering.Candidates(bins=jnp.asarray(bins_h[t]),
                                 intensity=jnp.asarray(int_h[t]),
                                 peak=jnp.asarray(peak_h[t])), cfg)
        np.testing.assert_array_equal(np.asarray(pc_dev.valid),
                                      np.asarray(pc_cand.valid))
        v = np.asarray(pc_dev.valid)
        np.testing.assert_allclose(np.asarray(pc_dev.xy)[v],
                                   np.asarray(pc_cand.xy)[v], atol=1e-6)


def test_cacfar_overflow_keeps_strongest():
    """More detections than the per-azimuth budget -> weakest dropped."""
    cfg = _cfar_cfg(kc=3)
    img = np.full((64, 256), 5, np.uint8)
    # five isolated strong returns on one azimuth, distinct intensities
    bins = [40, 70, 100, 130, 160]
    vals = [200, 210, 220, 230, 240]
    for b, v in zip(bins, vals):
        img[7, b] = v
    sel_bins, valid, sel_int = filtering.cfar_select(jnp.asarray(img), cfg)
    got = sorted(np.asarray(sel_bins)[7][np.asarray(valid)[7]].tolist())
    assert got == [100, 130, 160]     # the three strongest


def test_min_range_gate():
    cfg = _cfg()
    img = np.zeros((64, 256), np.uint8)
    img[0, 2] = 200     # bin 2 -> range 1.25 m < min_distance 2.5 (res 0.5)
    img[0, 100] = 200
    pc = filtering.filter_polar_image(jnp.asarray(img), cfg)
    valid = np.asarray(pc.valid)
    assert valid.sum() == 1


def test_intensity_filter_util():
    cfg = _cfg()
    img = np.zeros((64, 256), np.uint8)
    img[0, 100] = 200   # range 50.25 m (res 0.5)
    img[1, 40] = 70     # range 20.25 m, weak
    pc = filtering.filter_polar_image(jnp.asarray(img), cfg)
    out = filtering.intensity_filter(pc, threshold=100.0, min_range=0.0,
                                     max_range=60.0)
    assert int(np.asarray(out.valid).sum()) == 1
    out2 = filtering.intensity_filter(pc, threshold=60.0, min_range=0.0,
                                      max_range=30.0)
    assert int(np.asarray(out2.valid).sum()) == 1
