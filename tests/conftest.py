"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh (SURVEY.md section 4.4): the same
shard_map/pjit code then runs unmodified on the GPUs.  The platform is
switched in-process: request 8 CPU devices, select the cpu platform, and
drop any already-created backends.  Tests marked ``gpu`` need a GPU and
skip here (tests/test_chip_smoke.py decides that inside a fixture).
"""

import os
import sys

import jax

#: ``SLAMSIM_TEST_DEVICE=gpu`` leaves JAX's platform alone, for running
#: the ``gpu``-marked tests on a GPU (README, "Testing").
ON_GPU = os.environ.get("SLAMSIM_TEST_DEVICE") == "gpu"
if not ON_GPU:
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_platforms", "cpu")
    import jax.extend.backend as _jeb

    _jeb.clear_backends()
    assert len(jax.devices()) == 8 and jax.devices()[0].platform == "cpu", (
        "test harness requires a virtual 8-device CPU mesh; got "
        f"{jax.devices()}")

import numpy as np
import pytest

# The repo root, for chip_smoke and __graft_entry__.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound the in-process compiler/executable state of the full tier.

    The suite runs hundreds of distinct jit programs in one process on
    the virtual 8-device CPU backend; with enough accumulated state the
    XLA:CPU compiler segfaults inside ``backend_compile_and_load`` on a
    later (individually fine) compile — observed round 5 on merge-kernel
    tests when preceded by the full solver module, passing in isolation
    or any small module combination.  Dropping the jit caches at module
    boundaries keeps the live-state envelope flat; the smoke tier is
    unaffected (each module recompiles only its own programs).
    """
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(0)
