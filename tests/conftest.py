"""Shared test fixtures. NOTE: no XLA_FLAGS device-count override here —
smoke tests and benches must see the single real CPU device; only
launch/dryrun.py fakes 512 devices (per its module docstring).

Rank promotion is an error under test (set REPRO_RANK_PROMOTION=warn or
allow to relax locally): silent broadcast of mismatched ranks is how
per-client weight vectors end up averaged against full matrices."""

import os

import jax
import pytest

jax.config.update("jax_numpy_rank_promotion",
                  os.environ.get("REPRO_RANK_PROMOTION", "raise"))


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself without "
        "one (run on the card with `python -m pytest -m gpu tests/`)")
