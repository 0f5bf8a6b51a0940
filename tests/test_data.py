"""Data layer: BAL IO, priors, flags schedules."""

import numpy as np
import pytest

from gbp_poplar.config import GBPConfig
from gbp_poplar.utils import balio, flags as flags_lib, priors

from conftest import requires_sequences


def test_synthetic_problem_shapes(synthetic):
    p = synthetic
    assert p.cam_means.shape == (p.n_keyframes, 6)
    assert p.lmk_means.shape == (p.n_points, 3)
    assert p.measurements.shape == (p.n_edges, 2)
    assert p.cam_idx.max() < p.n_keyframes
    assert p.lmk_idx.max() < p.n_points


def test_bal_roundtrip(tmp_path, synthetic):
    path = tmp_path / "prob.txt"
    balio.save_bal(str(path), synthetic)
    back = balio.load_bal(str(path))
    assert back.n_keyframes == synthetic.n_keyframes
    assert back.n_edges == synthetic.n_edges
    np.testing.assert_allclose(back.k, synthetic.k)
    np.testing.assert_array_equal(back.cam_idx, synthetic.cam_idx)
    np.testing.assert_allclose(back.measurements, synthetic.measurements,
                               rtol=1e-5)
    np.testing.assert_allclose(back.cam_means, synthetic.cam_means, rtol=1e-9)


@requires_sequences
def test_load_tum_sequences():
    p = balio.load_bal("fr2robot2")
    assert (p.n_keyframes, p.n_points, p.n_edges) == (20, 862, 3551)
    # header intrinsics of the TUM fr2 camera
    assert 500 < p.k[0, 0] < 540
    p2 = balio.load_bal("fr1xyz")
    assert (p2.n_keyframes, p2.n_points, p2.n_edges) == (42, 2194, 12908)


def test_prior_lambdas_positive(synthetic):
    cam_lam, lmk_lam = priors.prior_lambdas(synthetic, meas_var=4.0)
    assert (np.asarray(cam_lam) > 0).all()
    assert (np.asarray(lmk_lam) > 0).all()


def test_prior_lambda_matches_bruteforce(synthetic):
    """Vectorised segment-max prior equals the reference's O((C+L)E) scan."""
    import jax.numpy as jnp
    from gbp_poplar.ops import projection
    cam_lam, lmk_lam = priors.prior_lambdas(synthetic, meas_var=4.0)
    k = jnp.asarray(synthetic.k, jnp.float32)
    for c in [0, synthetic.n_keyframes - 1]:
        best = 0.0
        for e in range(synthetic.n_edges):
            if synthetic.cam_idx[e] != c:
                continue
            jac = projection.reproj_jacobian_local(
                jnp.asarray(synthetic.cam_means[c], jnp.float32),
                jnp.asarray(synthetic.lmk_means[synthetic.lmk_idx[e]], jnp.float32),
                k)
            best = max(best, float(np.abs(np.asarray(jac)).max()))
        np.testing.assert_allclose(float(cam_lam[c]), best**2 / 4.0, rtol=1e-4)


def test_ba_flags(synthetic):
    fl = flags_lib.ba_flags(synthetic, steps=5)
    assert (fl.active_flag == 1).all()
    assert (fl.cam_weaken_flag == 5).all()


def test_slam_flag_schedule(synthetic):
    steps = 5
    fl = flags_lib.create_flags(synthetic, steps)
    first_two = (synthetic.cam_idx <= 1)
    np.testing.assert_array_equal(fl.active_flag.astype(bool), first_two)
    assert (fl.cam_weaken_flag[:2] == steps).all()
    assert (fl.cam_weaken_flag[2:] == 0).all()

    total_new = int((fl.lmk_weaken_flag == steps).sum())
    for kf in range(1, synthetic.n_keyframes - 1):
        fl, n_new = flags_lib.update_flags(synthetic, fl, steps, kf - 1)
        seen_edges = synthetic.cam_idx <= kf
        np.testing.assert_array_equal(fl.active_flag.astype(bool), seen_edges)
        assert fl.cam_weaken_flag[kf] == steps
        assert (np.delete(fl.cam_weaken_flag, kf) == 0).all()
        # newly-weakened landmarks are exactly those first seen now
        total_new += n_new
    assert total_new == len(np.unique(synthetic.lmk_idx))


def test_av_depth_init(synthetic):
    out = priors.av_depth_init(synthetic, 1.0, synthetic.cam_means)
    # every observed landmark sits at depth ~1 of its first observing kf
    first_cam = {}
    order = np.argsort(synthetic.cam_idx, kind="stable")
    for e in order:
        l = synthetic.lmk_idx[e]
        if l not in first_cam:
            first_cam[l] = synthetic.cam_idx[e]
    for l, c in list(first_cam.items())[:10]:
        x = synthetic.cam_means[c]
        r = priors._so3exp_np(x[3:])
        z = (r @ out[l] + x[:3])[2]
        np.testing.assert_allclose(z, 1.0, atol=1e-5)


def test_init_noise_preserves_anchors(synthetic):
    from gbp_poplar.config import InitConfig
    cfg = InitConfig(trans_noise=0.1, rot_noise=1.0, seed=1)
    out = priors.apply_init_noise(synthetic, cfg)
    np.testing.assert_allclose(out.cam_means[:2], synthetic.cam_means[:2])
    assert not np.allclose(out.cam_means[2:], synthetic.cam_means[2:])


def test_load_compressed_bal(tmp_path):
    """Published BAL datasets ship as problem-*.txt.bz2; the loader
    decompresses transparently (the reference requires pre-decompressed
    files) and autodetection still works through the compression."""
    import bz2

    from gbp_poplar.utils.balio import save_bal, synthetic_problem

    prob = synthetic_problem(n_keyframes=4, n_points=20, seed=2)
    plain = tmp_path / "seq.txt"
    save_bal(str(plain), prob)
    comp = tmp_path / "seq.txt.bz2"
    comp.write_bytes(bz2.compress(plain.read_bytes()))
    a = balio.load_bal(str(plain))
    b = balio.load_bal(str(comp))
    np.testing.assert_array_equal(a.cam_idx, b.cam_idx)
    np.testing.assert_array_equal(a.measurements, b.measurements)
    np.testing.assert_array_equal(a.cam_means, b.cam_means)
