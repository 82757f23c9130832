"""Marks `slow` the three JAX-only mesh tests that tier-1 (`-m 'not slow'`)
leaves out; `python -m pytest tests/test_parallel.py -m slow` runs them.

Imports neither JAX nor torch: it also loads where only the port runs.
"""

from pathlib import Path

import pytest

_MESH_TESTS = Path(__file__).parent / "tests" / "test_parallel.py"

# Seconds on one CPU worker: alone, then inside the whole tier-1 run. Each
# still runs under `-m slow`.
SLOW_MESH_TESTS = (
    "test_sharded_pallas_grads_match_unsharded",  # 334.5, 402.0
    "test_sharded_pallas_compact_backward_matches_unsharded",  # 299.9, 317.8
    "test_dagger_driver_passes_measured_bands",  # 191.2, 286.4
)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: takes minutes; tier-1 runs -m 'not slow'")


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    for item in items:
        if item.path == _MESH_TESTS and item.originalname in SLOW_MESH_TESTS:
            item.add_marker(pytest.mark.slow)
