"""Test configuration: run everything on a virtual 8-device CPU mesh.

Sharding tests need multiple devices; unit tests are indifferent. Setting the
flags here (before JAX initialises) keeps the suite hermetic — no accelerator
needed.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

# the drivers turn the persistent compile cache on; tests stay hermetic
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest

from gbp_poplar.utils import balio


@pytest.fixture(scope="session")
def synthetic():
    return balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                   pixel_noise=0.5)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


def has_sequences() -> bool:
    try:
        balio.find_sequence("fr2robot2")
        return True
    except FileNotFoundError:
        return False


requires_sequences = pytest.mark.skipif(
    not has_sequences(), reason="TUM sequences not available"
)


# ---------------------------------------------------------------------------
# Two-tier suite: `pytest -q` runs the FAST tier (<10 min) via addopts
# `-m "not slow"` (pyproject.toml); `pytest -q -m ""` runs everything.
# Tests measured >= ~20 s on the reference CI box are tiered here in one
# place (plus the per-file pytestmark in test_drivers/test_tum_regression
# and the @slow decorators in test_snavely).
# ---------------------------------------------------------------------------
_SLOW_TESTS = frozenset({
    # test_gbp_core (full multi-chunk solves)
    "test_warm_override_matches_static_offset",
    "test_solve_runs_and_is_finite",
    "test_diagnostics_flag_does_not_change_solution",
    "test_static_accel_elision_matches_traced_gating",
    # test_gauss_newton / test_coarse (converged-agreement solves)
    "test_gn_matches_gbp_solution",
    "test_zero_increment_at_gn_optimum",
    # test_slam (incremental end-to-end)
    "test_slam_matches_batch_quality",
    "test_insert_keyframe_semantics",
    "test_slam_end_to_end",
    # test_sharding (multi-device convergence runs)
    "test_map_sharded_converges_like_single",
    "test_sharded_converges_like_single",
    "test_padding_is_inert",
    "test_map_sharded_slam",
    "test_sharded_sweep_and_init",
    # test_snavely (sharded BAL-model solves not already @slow)
    "test_snavely_sharded_matches_single",
})


def pytest_collection_modifyitems(config, items):
    for item in items:
        name = getattr(item, "originalname", None) or item.name
        if name in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
