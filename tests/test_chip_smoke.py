"""chip_smoke.py on the CPU at small sizes: every phase's control flow and
checks, and its refusal to run anywhere but on a GPU."""

import types

import jax
import pytest

import chip_smoke


@pytest.mark.parametrize("platform", ["cpu", "rocm", "gpu"])
def test_require_gpu(platform):
    devices = [types.SimpleNamespace(platform=platform)]
    if platform == "gpu":
        chip_smoke.require_gpu(devices)
    else:
        with pytest.raises(SystemExit, match="needs a GPU"):
            chip_smoke.require_gpu(devices)


def test_main_refuses_cpu_and_prints_no_result(capsys):
    cache_dir = jax.config.jax_compilation_cache_dir
    try:
        with pytest.raises(SystemExit) as exc:
            chip_smoke.main([])
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_check_fails_on_excess_and_nan():
    chip_smoke.check("T", "within", 1.0, 1.0)
    for err in (1.5, float("nan")):
        with pytest.raises(AssertionError):
            chip_smoke.check("T", "outside", err, 1.0)


def test_phase_a_small():
    chip_smoke.phase_a(n_mics=64, grid=9, n_check=16)


def test_phase_b_small():
    t = chip_smoke.phase_b(n_blocks=48, batch=8, mimo_res=16, warm=2)
    assert t["live_blocks"] == 46 and t["replay_blocks_per_s"] > 0


def test_phase_c_small():
    t = chip_smoke.phase_c(channels=64, grid=16, n_batches=4, batch=12,
                           chain_blocks=16)
    assert t["config3_blocks_per_s"] > 0 and t["chain_us_per_block"] > 0
    assert t["config3_pipelines_blocks_per_s"] >= t["config3_blocks_per_s"]


def test_phase_d_small():
    chip_smoke.phase_d(grid=8, n_blocks=4)


def test_phase_sharded_small():
    chip_smoke.phase_sharded(4, n_mics=64, grid=9)
