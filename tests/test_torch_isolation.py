"""Test isolation between the JAX package's test files.

``tests/test_fused_step.py`` runs the JAX fused decode step (``DIA_FUSED=1``),
whose traces stay in JAX's in-process caches; a later
``tests/test_cbatch.py::test_kv_int8_lanes_match_single_stream`` in the same
process then reuses them and fails.  Whether the two files share a process
depends on how pytest-xdist spreads the files over its workers, so a new test
file anywhere can bring the failure back.

This module registers itself as a plugin (``pytest_plugins``) when it is
collected, which happens in every worker, and clears JAX's caches after the
last test of ``test_fused_step.py``.  It never imports JAX itself: it clears
the caches only where JAX is already loaded.
"""

import sys

import pytest

pytest_plugins = [__name__]

_LEAKY_FILE = "test_fused_step.py"


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    if item.path.name != _LEAKY_FILE:
        return
    if nextitem is not None and nextitem.path == item.path:
        return
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()


def test_isolation_plugin_is_registered(request):
    plugin = request.config.pluginmanager.get_plugin(__name__)
    assert plugin is sys.modules[__name__]
    hooks = request.config.pluginmanager.hook.pytest_runtest_teardown.get_hookimpls()
    assert any(impl.plugin is plugin for impl in hooks)
