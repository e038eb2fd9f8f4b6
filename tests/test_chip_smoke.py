"""``chip_smoke.py``: its checks at small sizes here, at full size on a GPU.

The ``gpu``-marked tests call the smoke test's own phase functions at
their default (full) sizes and skip where JAX sees no GPU; the others
run the same functions on the CPU at small sizes, with the kernel in
the Pallas interpreter, plus the script's device and cache rules.
"""

import os

import jax
import pytest

import chip_smoke
from slamsim.utils import runtime


@pytest.fixture
def gpu():
    """The first GPU, or a skip: decided at run time, never at import."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (run with SLAMSIM_TEST_DEVICE=gpu)")
    return devices[0]


@pytest.mark.gpu
class TestOnGpu:
    def test_ekf_noise_free(self, gpu):
        chip_smoke.ekf_noise_free()

    def test_ekf_bands(self, gpu):
        chip_smoke.ekf_bands()

    def test_ekf_device_vs_host(self, gpu):
        chip_smoke.ekf_device_vs_host()

    def test_pf_bands(self, gpu):
        chip_smoke.pf_bands()

    def test_graph_solvers(self, gpu):
        chip_smoke.graph_solvers()


class TestDeviceRules:
    def test_refuses_cpu_device(self):
        with pytest.raises(RuntimeError, match="GPU"):
            runtime.require_gpu(jax.devices("cpu"))

    def test_refuses_too_few_gpus(self):
        class FakeGpu:
            platform = "gpu"

        with pytest.raises(RuntimeError):
            runtime.require_gpu([FakeGpu()], count=4)
        assert runtime.require_gpu([FakeGpu()] * 4, count=4)

    def test_main_fails_without_gpu(self, capsys):
        with pytest.raises(RuntimeError):
            chip_smoke.main([])
        assert '"ok"' not in capsys.readouterr().out


class TestCompileCache:
    def test_fixed_path_inside_checkout(self, tmp_path):
        env = {"HOME": "/elsewhere"}
        path = runtime.compile_cache_dir(env, tmp_path)
        assert path == os.path.join(str(tmp_path), ".jax_cache")
        # One path, whatever the process: no pid, time or temp name.
        assert runtime.compile_cache_dir(dict(env), tmp_path) == path

    @pytest.mark.parametrize("value", ["/cache/from/env", "relative"])
    def test_environment_wins(self, tmp_path, value):
        env = {runtime.CACHE_ENV: value}
        assert runtime.compile_cache_dir(env, tmp_path) is None

    def test_cache_dir_is_ignored_by_git(self):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        with open(os.path.join(root, ".gitignore")) as f:
            assert runtime.CACHE_SUBDIR + "/" in f.read().split()


class TestPhasesSmall:
    """The multi-device phases on four virtual CPU devices."""

    def test_four_ekf_sweeps(self):
        out = chip_smoke.four_ekf_sweeps(jax.devices()[:4], batch=64,
                                         n_steps=6, interpret=True)
        assert out["xla_state_diff"] <= 1e-5

    def test_four_pf_step(self):
        out = chip_smoke.four_pf_step(jax.devices()[:4], n_particles=4096)
        assert out["particles"] <= 1e-5

    def test_four_graph(self):
        chip_smoke.four_graph(jax.devices()[:4], n_poses=128,
                              n_landmarks=12, window=4, scan_chunk=None)

    def test_graph_solvers_small(self):
        out = chip_smoke.graph_solvers(n_poses=2048, n_landmarks=256,
                                       window=16)
        assert out["rmse"] < out["odom_rmse"]
