import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """Long single-process test runs exhaust XLA's JIT dylib space; clearing
    compiled-executable caches between modules keeps the suite stable."""
    yield
    jax.clear_caches()


# -- optional hypothesis shim -------------------------------------------------
# hypothesis is an optional dependency: test modules do
# ``from conftest import given, settings, st`` and their property sweeps
# become skipped tests when it is absent, while fixed-case tests keep running.
try:
    from hypothesis import given, settings, strategies as st  # noqa: F401
except ImportError:

    def _skip_without_hypothesis(*_a, **_k):
        def deco(fn):
            return pytest.mark.skip(reason="hypothesis not installed")(fn)

        return deco

    given = settings = _skip_without_hypothesis

    class st:  # placeholder strategies (never evaluated)
        sampled_from = integers = staticmethod(lambda *_a, **_k: None)
