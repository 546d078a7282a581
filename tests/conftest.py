import os
import sys

# Smoke tests and benches must see ONE device; only launch/dryrun.py (run
# as its own process) sets the 512-device flag.
assert "xla_force_host_platform_device_count" not in \
    os.environ.get("XLA_FLAGS", ""), \
    "tests must not inherit the dry-run's forced device count"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one); run them "
        "on the card with `python -m pytest -m cuda tests/test_torch_*.py`")
