"""Test harness config: pin the CPU backend and expose 8 virtual host
devices so multi-device sharding is testable on one host (SURVEY.md §4).

``TESTS_ON_GPU=1`` (set by chip_smoke.py for its in-process
``pytest -m gpu`` run) leaves the backend alone, so the gpu-marked tests
run on the card the calling process already holds.
"""

import os
import sys

import pytest

if os.environ.get("TESTS_ON_GPU") != "1":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(__file__))


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    return devs[0]
