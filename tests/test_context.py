"""DeviceContext discovery/meshes and the compile-cache location."""

import pathlib

import jax
import pytest

from vkradixsort_tpu.engine import context


@pytest.fixture
def cache_config():
    """Restore JAX's cache setting after a test that moves it."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv(context.CACHE_ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert context.use_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv(context.CACHE_ENV, raising=False)
    path = context.use_compile_cache()
    checkout = pathlib.Path(context.__file__).resolve().parents[2]
    assert path == str(checkout / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # a fixed path: the same on every call
    assert context.use_compile_cache() == path


def test_device_info():
    info = context.DeviceContext().info
    assert info.platform == "cpu"
    assert info.num_devices == len(jax.devices())
    assert info.kind


def test_mesh_1d_prefix():
    mesh = context.DeviceContext().mesh_1d("y", num_devices=4)
    assert mesh.axis_names == ("y",)
    assert list(mesh.devices.flat) == jax.devices()[:4]


def test_empty_device_list_raises():
    with pytest.raises(RuntimeError, match="no JAX devices"):
        context.DeviceContext([])
