import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from cfear_jax.config import preset
from cfear_jax.ops import features
from cfear_jax.ops.filtering import PointCloud
from cfear_jax.utils import se2

from oracles import voxel_cells_oracle


def _cfg(res=3.0, weight_intensity=True, max_cells=256):
    cfg = preset("CFEAR-3", dataset="synthetic")
    feat = dataclasses.replace(cfg.feature, res=res,
                               weight_intensity=weight_intensity,
                               max_cells=max_cells)
    radar = dataclasses.replace(cfg.radar, max_distance=80.0, n_bins=512,
                                range_res=0.175)
    return cfg.replace(feature=feat, radar=radar)


def _cloud(xy, intens, budget=2048):
    n = xy.shape[0]
    pad = budget - n
    xy = np.concatenate([xy, np.zeros((pad, 2))]).astype(np.float32)
    intens = np.concatenate([intens, np.zeros(pad)]).astype(np.float32)
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return PointCloud(xy=jnp.asarray(xy), intensity=jnp.asarray(intens),
                      valid=jnp.asarray(valid), peak=jnp.asarray(valid))


def _match_cells(got, oracle_cells, atol_mean=1e-3):
    """Greedy-match computed cells to oracle cells by mean distance."""
    assert len(oracle_cells) > 0
    gmeans = got["mean"]
    used = set()
    for oc in oracle_cells:
        d = np.linalg.norm(gmeans - oc["mean"], axis=1)
        for j in np.argsort(d):       # nearest unused (duplicate cells are
            if int(j) not in used:    # legitimate when search discs coincide)
                break
        j = int(j)
        assert d[j] < atol_mean, f"no matching cell for {oc['mean']} ({d[j]})"
        used.add(j)
        yield j, oc


def test_cells_match_oracle_random_cloud():
    rng = np.random.default_rng(0)
    cfg = _cfg()
    n = 600
    xy = rng.uniform(-40, 40, (n, 2))
    intens = rng.uniform(60, 200, n)
    cells = features.compute_cells(_cloud(xy, intens), cfg)
    valid = np.asarray(cells.valid)
    got = {k: np.asarray(getattr(cells, k))[valid]
           for k in ("mean", "normal", "cov", "nsamples", "planarity")}
    oracle = voxel_cells_oracle(xy, intens, cfg.feature.res, True)
    assert valid.sum() == len(oracle), (valid.sum(), len(oracle))
    for j, oc in _match_cells(got, oracle):
        np.testing.assert_allclose(got["cov"][j], oc["cov"], atol=2e-3)
        assert got["nsamples"][j] == oc["nsamples"]
        # normals defined up to sensor-flip convention; compare directions
        dot = abs(got["normal"][j] @ oc["normal"])
        assert dot > 0.999, (got["normal"][j], oc["normal"])
        np.testing.assert_allclose(got["planarity"][j], oc["planarity"],
                                   rtol=1e-3, atol=1e-3)


def test_cells_unweighted():
    rng = np.random.default_rng(1)
    cfg = _cfg(weight_intensity=False)
    n = 300
    xy = rng.uniform(-30, 30, (n, 2))
    intens = rng.uniform(60, 200, n)
    cells = features.compute_cells(_cloud(xy, intens), cfg)
    oracle = voxel_cells_oracle(xy, intens, cfg.feature.res, False)
    assert int(np.asarray(cells.valid).sum()) == len(oracle)


def test_normal_orientation_toward_sensor():
    # a wall segment along y at x=20: normal must point toward origin (-x)
    cfg = _cfg()
    ys = np.linspace(-2, 2, 30)
    xy = np.stack([np.full_like(ys, 20.0) +
                   np.random.default_rng(2).normal(0, 0.05, ys.shape), ys], -1)
    intens = np.full(30, 150.0)
    cells = features.compute_cells(_cloud(xy, intens), cfg)
    valid = np.asarray(cells.valid)
    assert valid.sum() >= 1
    for nvec in np.asarray(cells.normal)[valid]:
        assert nvec[0] < -0.99      # pointing back at the sensor


def test_min_samples_gate():
    cfg = _cfg()
    xy = np.array([[10.0, 10.0], [10.2, 10.1], [10.1, 9.9]])  # only 3 points
    intens = np.full(3, 150.0)
    cells = features.compute_cells(_cloud(xy, intens), cfg)
    assert int(np.asarray(cells.valid).sum()) == 0


def test_degenerate_line_gated_by_det():
    # perfectly collinear points -> det ~ 0 -> invalid (pointnormal.cpp:53-56)
    cfg = _cfg()
    xs = np.linspace(-1, 1, 20)
    xy = np.stack([10.0 + xs, np.full_like(xs, 10.0)], -1)
    intens = np.full(20, 150.0)
    cells = features.compute_cells(_cloud(xy, intens), cfg)
    assert int(np.asarray(cells.valid).sum()) == 0


def test_transform_cells_roundtrip():
    rng = np.random.default_rng(3)
    cfg = _cfg()
    xy = rng.uniform(-30, 30, (400, 2))
    intens = rng.uniform(80, 200, 400)
    cells = features.compute_cells(_cloud(xy, intens), cfg)
    pose = jnp.asarray([2.0, -1.0, 0.7], jnp.float32)
    fwd = features.transform_cells(cells, pose)
    back = features.transform_cells(fwd, se2.inverse(pose))
    np.testing.assert_allclose(np.asarray(back.mean), np.asarray(cells.mean),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(back.cov), np.asarray(cells.cov),
                               atol=1e-4)
    # covariance must rotate as R C R^T: eigenvalues invariant
    for j in np.where(np.asarray(cells.valid))[0][:5]:
        e0 = np.linalg.eigvalsh(np.asarray(cells.cov)[j])
        e1 = np.linalg.eigvalsh(np.asarray(fwd.cov)[j])
        np.testing.assert_allclose(e0, e1, atol=1e-4)


def test_compensate_cells_identity():
    rng = np.random.default_rng(4)
    cfg = _cfg()
    xy = rng.uniform(-30, 30, (400, 2))
    intens = rng.uniform(80, 200, 400)
    cells = features.compute_cells(_cloud(xy, intens), cfg)
    out = features.compensate_cells(cells, jnp.zeros(3), ccw=False)
    np.testing.assert_allclose(np.asarray(out.mean), np.asarray(cells.mean),
                               atol=1e-6)


def test_compute_cells_batched_matches_per_lane():
    """The hand-batched feature stage (one segment sum for all lanes) must
    give every lane the bits of compute_cells on that lane alone: its sums
    add in a per-lane order."""
    import jax

    rng = np.random.default_rng(9)
    cfg = _cfg()
    clouds = []
    for s in range(3):
        n = 300 + 40 * s
        xy = rng.uniform(-40, 40, (n, 2))
        intens = rng.uniform(70, 220, n)
        clouds.append(_cloud(xy, intens))
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *clouds)
    got = features.compute_cells_batched(batch, cfg)
    for i, c in enumerate(clouds):
        ref = features.compute_cells(c, cfg)
        for f in ref._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(got, f)[i]), np.asarray(getattr(ref, f)),
                err_msg=f"lane {i} field {f}")


def _segment_case(case, rng, b=3, n=257, s=40, c=5):
    data = rng.normal(size=(b, n, c)).astype(np.float32)
    if case == "random":           # ids in [0, s], s = dropped
        seg = rng.integers(0, s + 1, (b, n))
    elif case == "all_dropped":
        seg = np.full((b, n), s)
    elif case == "one_segment":    # one segment spans every row of a lane
        seg = np.tile(np.array([[7], [0], [s - 1]]), (1, n))
    else:                          # "singletons": every kept id once
        perm = np.stack([rng.permutation(n) for _ in range(b)])
        seg = np.where(perm < s, perm, s)
    return data, seg.astype(np.int32), s


@pytest.mark.parametrize("case", ["random", "all_dropped", "one_segment",
                                  "singletons"])
def test_segment_sum_lanes_matches_numpy(case):
    """`_segment_sum_lanes` against np.add.at per lane (id s dropped), and
    each lane alone gives the bits it gives in the batch."""
    import jax

    data, seg, s = _segment_case(case, np.random.default_rng(4))
    run = jax.jit(lambda d, g: features._segment_sum_lanes(
        d, features._segment_plan(g, s), s))
    got = np.asarray(run(data, seg))
    ref = np.zeros((data.shape[0], s + 1, data.shape[2]))
    for lane in range(data.shape[0]):
        np.add.at(ref[lane], seg[lane], data[lane].astype(np.float64))
    np.testing.assert_allclose(got, ref[:, :s], rtol=1e-5, atol=1e-5)
    for lane in range(data.shape[0]):
        alone = np.asarray(run(data[lane:lane + 1], seg[lane:lane + 1]))
        np.testing.assert_array_equal(alone[0], got[lane])


def test_point_budget_compaction_identical():
    """feature.point_budget compaction: identical cells while the valid
    count fits the budget."""
    from cfear_jax.datasets import synthetic
    from cfear_jax.ops import filtering

    cfg = _cfg()
    rng = np.random.default_rng(3)
    world = synthetic.make_world(rng)
    img = synthetic.render_polar(world, np.zeros(3), cfg, rng)
    pts = filtering.filter_polar_image(jnp.asarray(img), cfg)
    n_valid = int(np.asarray(pts.valid).sum())
    budget = ((n_valid + 255) // 256 + 1) * 256
    cfg_b = cfg.replace(feature=dataclasses.replace(
        cfg.feature, point_budget=budget))
    c0 = features.compute_cells(pts, cfg)
    c1 = features.compute_cells(pts, cfg_b)
    assert int(c0.n) == int(c1.n)
    v0, v1 = np.asarray(c0.valid), np.asarray(c1.valid)
    m0 = np.asarray(c0.mean)[v0]
    m1 = np.asarray(c1.mean)[v1]
    key0 = np.lexsort((m0[:, 1], m0[:, 0]))
    key1 = np.lexsort((m1[:, 1], m1[:, 0]))
    np.testing.assert_allclose(m0[key0], m1[key1], atol=1e-5)


def test_spatial_sort_is_a_morton_permutation():
    """`feature.spatial_sort` only re-orders the kept cells: the same cell
    set as the unsorted map, valid cells first, in non-decreasing Morton
    order of their voxel — the tile coherence the block-sparse association
    kernel's skipping relies on."""
    import math

    import jax

    from cfear_jax.datasets import synthetic
    from cfear_jax.ops import filtering
    from cfear_jax.utils import native_io

    cfg = preset("CFEAR-3", dataset="synthetic")
    cfg = cfg.replace(feature=dataclasses.replace(
        cfg.feature, max_cells=512, point_budget=1024))
    images, _ = synthetic.make_sequence(seed=2, n_frames=3, cfg=cfg,
                                        speed=6.0)
    f = cfg.filter
    min_bin = int(math.ceil(cfg.radar.min_distance / cfg.radar.range_res))
    bb, aa, ii, pp = native_io.filter_frames_host_compact(
        images, f.k_strongest, f.z_min, f.nms_window,
        cfg.feature.point_budget, min_bin)
    comp = filtering.CompactCandidates(
        bins=jnp.asarray(bb), azimuth=jnp.asarray(aa),
        intensity=jnp.asarray(ii), peak=jnp.asarray(pp))
    pts = jax.vmap(lambda c: filtering.points_from_compact(c, cfg))(comp)

    cm_u = features.compute_cells_batched(pts, cfg)
    cm_s = features.compute_cells_batched(
        pts, cfg.replace(feature=dataclasses.replace(cfg.feature,
                                                     spatial_sort=True)))
    leaf, dim, _ = features._grid_geometry(cfg)
    for b in range(3):
        vu = np.asarray(cm_u.valid[b])
        vs = np.asarray(cm_s.valid[b])
        n = int(vs.sum())
        assert vu.sum() == n > 50
        assert vs[:n].all() and not vs[n:].any()          # valid first
        mu = np.asarray(cm_u.mean[b])[vu]
        ms = np.asarray(cm_s.mean[b])[vs]
        ou = np.lexsort((mu[:, 1], mu[:, 0]))
        os_ = np.lexsort((ms[:, 1], ms[:, 0]))
        np.testing.assert_array_equal(mu[ou], ms[os_])     # same set
        vox = np.floor(ms / leaf).astype(np.int32) + dim // 2
        code = np.asarray(features._morton2(jnp.asarray(vox[:, 0]),
                                            jnp.asarray(vox[:, 1])))
        # cell means sit within one voxel of their own voxel's center, so
        # the codes of the voxels containing them are near-sorted; exact
        # order holds for the voxel index the sort used, checked via
        # the coarse (2x2-voxel) code which a one-voxel offset rarely flips
        assert np.mean(np.diff(code >> 2) >= 0) > 0.9
