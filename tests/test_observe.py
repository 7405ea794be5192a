"""Observability helpers: progress gating, timed rates, profiler no-op."""

import io

from fastsk_jax.utils.observe import (
    Progress,
    enable_compilation_cache,
    profiler_trace,
    timed,
)


def test_progress_quiet_gating():
    buf = io.StringIO()
    Progress(quiet=True, stream=buf).log("hidden")
    assert buf.getvalue() == ""
    buf2 = io.StringIO()
    Progress(quiet=False, stream=buf2).log("shown")
    out = buf2.getvalue()
    assert "shown" in out and out.startswith("[fastsk +")


def test_timed_reports_wall_and_rate():
    buf = io.StringIO()
    p = Progress(quiet=False, stream=buf)
    with timed(p, "span", work_items=100, unit="pairs") as info:
        pass
    assert info["wall_s"] >= 0
    assert info["rate"] > 0
    assert "pairs/s" in buf.getvalue()


def test_profiler_trace_noop_without_dir():
    with profiler_trace(None):
        x = 1
    assert x == 1


def test_compilation_cache_honours_env_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    the code sets no other."""
    import jax

    from fastsk_jax.utils import observe

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert enable_compilation_cache() == str(tmp_path / "cc")
    assert observe.compilation_cache_dir() == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == before


def test_compilation_cache_default_is_fixed_in_checkout(monkeypatch):
    """Without the env var the cache is ``.jax_cache`` in the checkout —
    the same path every time, never under ``~/.cache``."""
    import os

    import jax

    from fastsk_jax.utils import observe

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compilation_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert path == observe.compilation_cache_dir()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
