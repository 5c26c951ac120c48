import dataclasses

import numpy as np
import jax

from cfear_jax.config import preset
from cfear_jax.datasets import synthetic
from cfear_jax.models import odometry
from cfear_jax.parallel import mesh as pmesh


def _cfg():
    cfg = preset("CFEAR-3", dataset="synthetic")
    radar = dataclasses.replace(cfg.radar, n_azimuths=128, n_bins=256,
                                range_res=0.6, max_distance=100.0)
    feat = dataclasses.replace(cfg.feature, max_cells=256)
    filt = dataclasses.replace(cfg.filter, k_strongest=8)
    return cfg.replace(radar=radar, feature=feat, filter=filt)


def test_eight_device_mesh_available():
    assert len(jax.devices()) == 8


def test_multi_sequence_sharded_matches_single():
    cfg = _cfg()
    b, t = 8, 8
    seqs, gts = [], []
    for s in range(b):
        imgs, gt = synthetic.make_sequence(seed=100 + s, n_frames=t, cfg=cfg)
        seqs.append(imgs)
        gts.append(gt)
    images = np.stack(seqs)

    m = pmesh.make_mesh(8)
    runner = pmesh.MultiSequenceRunner(cfg, batch=b, mesh=m, chunk=4)
    runner.process(images)
    trajs = runner.trajectories()
    assert trajs.shape == (b, t, 3)

    # every sharded lane must track its own ground truth; exact equality with
    # an unbatched run is not guaranteed (vmapped while_loops/conds reorder
    # f32 reductions, and a near-threshold keyframe gate may flip), so check
    # functional equivalence instead
    from cfear_jax.eval.trajectory import ate_rmse
    for s in range(b):
        err = np.linalg.norm(trajs[s, :, :2] - gts[s][:, :2], axis=1).max()
        assert err < 1.0, (s, err)

    single = odometry.OdometryRunner(cfg, chunk=4)
    single.process(seqs[0])
    ate_b = ate_rmse(trajs[0][:, :2], gts[0][:, :2])
    ate_s = ate_rmse(single.trajectory()[:, :2], gts[0][:, :2])
    assert abs(ate_b - ate_s) < 0.25, (ate_b, ate_s)


def test_sharded_state_layout():
    from jax.sharding import NamedSharding
    cfg = _cfg()
    m = pmesh.make_mesh(8)
    init_fn, _, _, _ = pmesh.make_batched_runner(cfg, m)
    states = init_fn(8)
    sh = states.kf_poses.sharding
    assert isinstance(sh, NamedSharding)
    assert sh.spec[0] == "data"


def test_multi_sequence_host_ingest_matches_image_ingest():
    """Batched candidates ingest == batched image ingest, per lane."""
    cfg = _cfg()
    b, t = 4, 6
    images = np.stack([synthetic.make_sequence(seed=200 + s, n_frames=t,
                                               cfg=cfg)[0] for s in range(b)])
    m = pmesh.make_mesh(4)
    r_img = pmesh.MultiSequenceRunner(cfg, batch=b, mesh=m, chunk=3)
    r_img.process(images)
    r_host = pmesh.MultiSequenceRunner(cfg, batch=b, mesh=m, chunk=3,
                                       ingest="host")
    r_host.process(images)
    np.testing.assert_allclose(r_img.trajectories(), r_host.trajectories(),
                               atol=1e-6)
