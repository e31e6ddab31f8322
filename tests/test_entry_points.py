"""Entry-point plumbing that must not depend on the device: CLI
defaults, the compilation-cache location, and the benchmark's refusal
to run without a GPU."""

import os
import sys

import jax
import pytest

from tpurt.config import RenderConfig
from tpurt.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cli_defaults_are_render_config_defaults():
    from tpurt.cli import build_parser

    args = build_parser().parse_args([])
    d = RenderConfig()
    assert args.pixels_per_lane == d.pixels_per_lane
    assert args.interleave == d.mega_interleave
    assert args.tail_passes == d.mega_tail_passes
    assert args.rays_per_batch == d.rays_per_batch
    assert args.engine == d.engine


def test_cli_defaults_do_not_depend_on_platform(monkeypatch):
    """The parser reads no device: a GPU-looking backend yields the
    same defaults as the CPU."""
    from tpurt.cli import build_parser

    cpu = vars(build_parser().parse_args([]))

    class FakeGpu:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jax, "devices", lambda *a, **k: [FakeGpu()])
    assert vars(build_parser().parse_args([])) == cpu


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 5


def test_compile_cache_env_var_wins(monkeypatch, tmp_path,
                                    restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set the helper sets no path in
    code: JAX's own setting stands."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def _bench(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    import bench

    return bench


def test_bench_refuses_to_run_without_gpu(monkeypatch, capsys):
    bench = _bench(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    assert jax.devices()[0].platform == "cpu"
    assert bench.main() == 1
    assert "no GPU" in capsys.readouterr().err


def test_bench_rows_name_the_device(monkeypatch):
    bench = _bench(monkeypatch)
    info = bench.device_info()
    assert info["platform"] == "cpu"
    assert info["count"] == len(jax.devices())
    assert {"device_kind", "name", "power_limit"} <= set(info)
