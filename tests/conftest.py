import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running property/parity suites (run via `make test-full`; "
        "`make test-fast` deselects them)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA kernels); skips "
        "inside the test where torch.cuda.is_available() is False")


# ---------------------------------------------------------------------------
# Virtual clock: the fault-injection suite (tests/test_runtime_faults.py)
# drives every timeout/deadline — circuit breaker, token bucket, cold-read
# timing — deterministically, with NO wall-clock sleeps. Inject it wherever
# a component takes a ``clock=`` callable (serve/admission.py,
# serve/tiered_store.py, BSEServer/CTRServer.build ``clock=``).
# ---------------------------------------------------------------------------
class VirtualClock:
    """Monotonic fake clock: calling it reads the time, ``advance`` moves
    it. Thread-safe so injected fault delays can tick from any thread."""

    def __init__(self, start: float = 0.0):
        import threading
        self._t = float(start)
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> float:
        assert dt >= 0, f"virtual time cannot go backwards ({dt})"
        with self._lock:
            self._t += dt
            return self._t


@pytest.fixture
def vclock():
    return VirtualClock()


# ---------------------------------------------------------------------------
# Optional hypothesis (see requirements-dev.txt): property-based tests import
# ``given/settings/st`` from here. Without hypothesis installed the decorated
# tests turn into clean skips while the deterministic suites still run.
# ---------------------------------------------------------------------------
try:
    from hypothesis import given, settings, strategies as st  # noqa: F401
    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False

    class _AnyStrategy:
        def __getattr__(self, name):
            return lambda *a, **k: None

    st = _AnyStrategy()

    def settings(*a, **k):
        return lambda f: f

    def given(*a, **k):
        def deco(f):
            def skipper():
                pytest.skip("hypothesis not installed")
            skipper.__name__ = f.__name__
            return skipper
        return deco
