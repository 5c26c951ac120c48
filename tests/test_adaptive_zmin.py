"""Adaptive noise-floor thresholding (`filter.z_min_quantile`).

The fixed z_min=60 detector drowns once the speckle floor reaches ~1.67x
nominal (eval_results/sim_sensitivity.csv beyond_envelope rows). The
adaptive mode replaces it per frame with max(z_min, q-quantile + 1) — an
exact integer rule shared bit-for-bit by the device filter
(`ops/filtering.py:frame_noise_threshold`) and the native host data plane
(`native/cfear_io.cpp:cfear_frame_thresholds`). These tests pin:

1. the three implementations (device, native, numpy oracle) agree exactly;
2. host-ingest and image-ingest pipelines stay identical with the flag on;
3. nominal worlds are untouched (quantile threshold < z_min);
4. the mitigation works: the noise_24 beyond-envelope collapse (12-94%
   drift with fixed z_min) tracks at ordinary drift with q=0.98.
"""

import dataclasses
import math

import numpy as np
import jax.numpy as jnp

from cfear_jax.config import preset
from cfear_jax.datasets import synthetic
from cfear_jax.models import odometry
from cfear_jax.ops import filtering
from cfear_jax.utils import native_io
from cfear_jax.eval.kitti import kitti_drift

Q = 0.98


def _oracle_thr(img, q, z_min):
    hist = np.bincount(img.ravel(), minlength=256)
    q_count = math.ceil(q * img.size)
    q_thr = int(np.argmax(np.cumsum(hist) >= q_count))
    return max(z_min, q_thr + 1)


def test_threshold_implementations_agree():
    rng = np.random.default_rng(3)
    for noise in (6.0, 12.0, 24.0, 48.0):
        imgs = np.clip(rng.exponential(noise, (4, 64, 256)), 0,
                       255).astype(np.uint8)
        want = np.asarray([_oracle_thr(im, Q, 60) for im in imgs], np.int32)
        got_native = native_io.frame_thresholds_host(imgs, Q, 60)
        np.testing.assert_array_equal(got_native, want)
        got_dev = np.asarray([
            int(filtering.frame_noise_threshold(jnp.asarray(im), Q, 60))
            for im in imgs])
        np.testing.assert_array_equal(got_dev, want)
    # nominal floor (exp mean 12): quantile sits BELOW z_min -> untouched
    imgs = np.clip(rng.exponential(12.0, (2, 64, 256)), 0,
                   255).astype(np.uint8)
    assert (native_io.frame_thresholds_host(imgs, Q, 60) == 60).all()


def test_host_filter_matches_device_with_quantile():
    cfg = preset("CFEAR-1", dataset="synthetic")
    rng = np.random.default_rng(9)
    a, r = cfg.radar.n_azimuths, cfg.radar.n_bins
    img = np.clip(rng.exponential(30.0, (a, r)) +
                  rng.integers(0, 2, (a, r)) * 180, 0, 255).astype(np.uint8)
    k = cfg.filter.k_strongest
    bins_h, int_h, peak_h = native_io.filter_frames_host(
        img, k, cfg.filter.z_min, cfg.filter.nms_window, z_quantile=Q)
    z = filtering.frame_noise_threshold(jnp.asarray(img), Q,
                                        cfg.filter.z_min)
    bins_d, valid_d = filtering.kstrongest_mask(jnp.asarray(img), k, z)
    peak_img = filtering.nms_peak_image(jnp.asarray(img),
                                        cfg.filter.nms_window)
    peaks_d = jnp.take_along_axis(peak_img, bins_d, axis=1) & valid_d
    np.testing.assert_array_equal(
        bins_h, np.where(np.asarray(valid_d), np.asarray(bins_d), -1))
    np.testing.assert_array_equal(peak_h.astype(bool), np.asarray(peaks_d))
    np.testing.assert_array_equal(
        int_h, np.where(np.asarray(valid_d),
                        np.take_along_axis(img, np.asarray(bins_d), axis=1),
                        0))


def test_host_ingest_matches_image_ingest_with_quantile():
    cfg = preset("CFEAR-3", dataset="synthetic")
    cfg = cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=256),
        filter=dataclasses.replace(cfg.filter, k_strongest=8,
                                   z_min_quantile=Q))
    images, gt = synthetic.make_sequence(seed=4, n_frames=12, cfg=cfg,
                                         noise_scale=24.0)
    r_img = odometry.OdometryRunner(cfg, chunk=4, ingest="image")
    r_img.process(images)
    r_host = odometry.OdometryRunner(cfg, chunk=4, ingest="host")
    r_host.process(images)
    np.testing.assert_allclose(r_img.trajectory(), r_host.trajectory(),
                               atol=1e-4)


def test_quantile_rescues_raised_noise_floor():
    """noise_scale=24 (2x nominal) collapses the fixed-z_min pipeline
    (12-94% drift, sim_sensitivity beyond_envelope rows); with the
    adaptive threshold it must track at ordinary drift."""
    cfg = preset("CFEAR-3", dataset="synthetic")
    cfg = cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=1024),
        filter=dataclasses.replace(cfg.filter, z_min_quantile=Q))
    images, gt = synthetic.make_sequence(seed=12, n_frames=96, cfg=cfg,
                                         speed=12.0, noise_scale=24.0)
    runner = odometry.OdometryRunner(cfg, chunk=16)
    runner.process(images)
    gt = np.asarray(gt)
    path = float(np.sum(np.linalg.norm(np.diff(gt[:, :2], axis=0), axis=1)))
    lengths = tuple(x for x in (50.0, 100.0) if x < 0.6 * path)
    d = kitti_drift(np.asarray(runner.trajectory()), gt, lengths=lengths)
    assert d["t_err_percent"] < 2.5, d
