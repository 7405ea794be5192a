"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh so sharding logic is exercised
hermetically, per the multi-host test strategy the reference lacks
(SURVEY.md §4). Environment must be set before jax is imported anywhere.

``JAX_PLATFORMS`` defaults to ``cpu``. The ``gpu`` tests
(tests/test_gpu_device.py) need a card: run them with
``JAX_PLATFORMS=cuda python -m pytest tests/test_gpu_device.py -m gpu``;
the ``gpu_device`` fixture skips them anywhere else.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

# in-repo fixtures: the reference's small.{train,test}.fasta and a
# 30-sequence EP300 slice with reference C++ goldens (golden/README.md)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# in-repo corpora: <name>.{train,test}.{pos,neg}.fasta (EP300, KAT2B)
CORPORA = os.path.normpath(
    os.path.join(GOLDEN, "..", "..", "experiments", "results_baselines", "tmp")
)


def pytest_collection_modifyitems(config, items):
    """Slow tests only run when FASTSK_RUN_SLOW=1."""
    if os.environ.get("FASTSK_RUN_SLOW") == "1":
        return
    skip_slow = pytest.mark.skip(reason="set FASTSK_RUN_SLOW=1 to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture
def gpu_device():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX_PLATFORMS=cuda); found {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def small_train():
    from fastsk_jax import FastaUtility

    reader = FastaUtility()
    X, Y = reader.read_data(os.path.join(GOLDEN, "small.train.fasta"))
    return X, Y, reader


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def random_ragged_seqs(rng, n, lmin, lmax, alphabet):
    return [
        rng.integers(1, alphabet + 1, size=rng.integers(lmin, lmax + 1)).tolist()
        for _ in range(n)
    ]
