import os

# Tests run on the single real CPU device (the 512-device override belongs
# ONLY to repro.launch.dryrun). Force determinism-friendly settings.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import jax


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Cap the per-process compile-cache footprint at one module's worth.

    The full suite compiles thousands of distinct executables in one
    process; letting them all accumulate eventually segfaults the XLA CPU
    compiler mid-``backend_compile`` (reproducibly, ~270 tests in).  Tests
    never share jit signatures across modules, so dropping the caches at
    module boundaries costs nothing and keeps the process healthy."""
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration tests")
    config.addinivalue_line(
        "markers",
        "properties: hypothesis-backed (or fixed-seed fallback) solver "
        "conformance suite — skipped by scripts/ci.sh --fast")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")
