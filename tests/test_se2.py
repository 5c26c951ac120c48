import jax.numpy as jnp
import numpy as np
import pytest

from cfear_jax.utils import se2


def rand_pose(rng):
    return jnp.asarray(rng.uniform(-5, 5, 3))


def test_compose_inverse_identity():
    rng = np.random.default_rng(0)
    for _ in range(10):
        a = rand_pose(rng)
        ident = se2.compose(a, se2.inverse(a))
        np.testing.assert_allclose(np.asarray(ident), 0.0, atol=1e-6)


def test_compose_matches_matrix_product():
    rng = np.random.default_rng(1)
    a, b = rand_pose(rng), rand_pose(rng)
    m = se2.to_matrix(np.asarray(se2.compose(a, b)))
    mm = se2.to_matrix(np.asarray(a)) @ se2.to_matrix(np.asarray(b))
    np.testing.assert_allclose(m[:2, 3], mm[:2, 3], atol=1e-6)
    np.testing.assert_allclose(m[:2, :2], mm[:2, :2], atol=1e-6)


def test_transform_points():
    pose = jnp.asarray([1.0, 2.0, np.pi / 2])
    pts = jnp.asarray([[1.0, 0.0], [0.0, 1.0]])
    out = np.asarray(se2.transform(pose, pts))
    np.testing.assert_allclose(out, [[1.0, 3.0], [0.0, 2.0]], atol=1e-6)


def test_exp_log_roundtrip():
    rng = np.random.default_rng(2)
    for _ in range(10):
        xi = jnp.asarray(rng.uniform(-2, 2, 3))
        back = se2.log(se2.exp(xi))
        np.testing.assert_allclose(np.asarray(back), np.asarray(xi),
                                   atol=1e-5)


def test_exp_small_angle():
    xi = jnp.asarray([1.0, -0.5, 1e-9])
    p = np.asarray(se2.exp(xi))
    np.testing.assert_allclose(p, [1.0, -0.5, 1e-9], atol=1e-7)


def test_rel_timestamp_convention():
    # GetRelTimeStamp (utils.h:28-32): atan2-based in [-0.5, 0.5]
    xy = jnp.asarray([[1.0, 0.001], [-1.0, 0.001], [-1.0, -0.001],
                      [0.001, 1.0]])
    d = np.asarray(se2.rel_timestamp(xy, ccw=False))
    assert abs(d[0] - (-0.5)) < 1e-3          # bearing ~0 -> start of scan
    assert abs(d[1] - 0.0) < 1e-3             # bearing pi -> mid scan
    assert abs(d[2] - 0.0) < 1e-3             # bearing -pi ~ pi
    assert abs(d[3] - (-0.25)) < 1e-3         # bearing pi/2
    d_ccw = np.asarray(se2.rel_timestamp(xy, ccw=True))
    np.testing.assert_allclose(d_ccw, -d, atol=1e-9)


def test_compensate_points_matches_per_point_transform():
    rng = np.random.default_rng(3)
    xy = jnp.asarray(rng.uniform(-50, 50, (100, 2)))
    tmot = jnp.asarray([0.8, 0.1, 0.05])
    out = np.asarray(se2.compensate_points(xy, tmot, ccw=False))
    d = np.asarray(se2.rel_timestamp(xy, False))
    for i in range(0, 100, 17):
        f = d[i]
        c, s = np.cos(f * 0.05), np.sin(f * 0.05)
        R = np.array([[c, -s], [s, c]])
        expect = R @ np.asarray(xy[i]) + f * np.array([0.8, 0.1])
        np.testing.assert_allclose(out[i], expect, atol=1e-5)


def test_normalize_angle():
    a = jnp.asarray([3 * np.pi, -3 * np.pi, 0.1])
    out = np.asarray(se2.normalize_angle(a))
    np.testing.assert_allclose(np.abs(out[:2]), np.pi, atol=1e-6)
    np.testing.assert_allclose(out[2], 0.1, atol=1e-7)
