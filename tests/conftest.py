import os

# Smoke tests and benches must see the single real CPU device; only the
# dry-run module requests 512 placeholder devices (and only in its own
# process).  Tests that need a small multi-device mesh spawn subprocesses
# (see test_sharding.py).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Tier-1 runs with the shadow-ledger sanitizer on: every refcount transition
# in the paged/tiered pools is mirrored and double-free / use-after-evict /
# teardown-leak raise immediately (repro.analysis.lint.runtime).  Opt out of
# an individual run with REPRO_SANITIZE=0.
os.environ.setdefault("REPRO_SANITIZE", "1")

import numpy as np
import pytest

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "src")


def subprocess_env(**extra):
    """Env for test subprocesses: absolute src prepended to the INHERITED
    PYTHONPATH (never clobbered -- pytest may run from outside the repo)."""
    env = dict(os.environ)
    inherited = env.get("PYTHONPATH")
    env["PYTHONPATH"] = _SRC + (os.pathsep + inherited if inherited else "")
    env.update(extra)
    return env


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); skips "
        "without one -- run on the card with `pytest -m gpu "
        "tests/test_torch_cuda.py`")
