"""Native (C++) BAL loader == NumPy reference parser."""

import numpy as np
import pytest

from gbp_poplar.utils import balio
from tests.conftest import requires_sequences


def _native_available():
    try:
        from gbp_poplar.native import balio_native
        balio_native._load_lib()
        return True
    except Exception:
        return False


requires_native = pytest.mark.skipif(
    not _native_available(), reason="no C++ toolchain for native loader")


@requires_native
@requires_sequences
def test_native_matches_numpy_parser():
    from gbp_poplar.native import balio_native

    path = balio.find_sequence("fr2robot2")
    a = balio_native.load(path)
    b = balio.load_bal(path, use_native=False)
    assert (a.n_keyframes, a.n_points, a.n_edges) == (
        b.n_keyframes, b.n_points, b.n_edges)
    np.testing.assert_array_equal(a.cam_idx, b.cam_idx)
    np.testing.assert_array_equal(a.lmk_idx, b.lmk_idx)
    np.testing.assert_allclose(a.measurements, b.measurements)
    np.testing.assert_allclose(a.cam_means, b.cam_means)
    np.testing.assert_allclose(a.lmk_means, b.lmk_means)
    np.testing.assert_allclose(a.k, b.k)


@requires_native
def test_native_roundtrip_via_save(tmp_path):
    from gbp_poplar.native import balio_native

    prob = balio.synthetic_problem(n_keyframes=4, n_points=20, seed=5)
    path = str(tmp_path / "tiny.txt")
    balio.save_bal(path, prob)
    a = balio_native.load(path)
    np.testing.assert_array_equal(a.cam_idx, prob.cam_idx)
    np.testing.assert_allclose(a.measurements, prob.measurements, rtol=1e-6)
    np.testing.assert_allclose(a.cam_means, prob.cam_means, rtol=1e-12)


@requires_native
def test_native_rejects_garbage(tmp_path):
    from gbp_poplar.native import balio_native

    path = str(tmp_path / "bad.txt")
    with open(path, "w") as f:
        f.write("not a bal file\n")
    with pytest.raises(ValueError):
        balio_native.load(path)
