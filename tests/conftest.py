import os
import sys

# smoke tests and benches must see 1 device (dry-run sets 512 in ITS process
# only); make CPU explicit and keep test x64 behaviour default.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# The target container ships without `hypothesis` (and without network to
# install it); fall back to the deterministic stub so the property tests
# still run. The real package always wins when present.
try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_stub

    sys.modules["hypothesis"] = _hypothesis_stub
    sys.modules["hypothesis.strategies"] = _hypothesis_stub.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the PyTorch port's kernels); "
                   "skips on a CPU-only host")


# Per-test wall-clock guard (CI sets REPRO_TEST_TIMEOUT, seconds): a wedged
# scheduler loop (the failure class the §16 front-end suite exists to
# catch) must fail ONE test with a traceback, not eat the whole job
# timeout. pytest-timeout isn't in the target container, so this is the
# SIGALRM equivalent: main-thread unix only; elsewhere it degrades to a
# no-op rather than skipping the suite.
_TEST_TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT", "0"))

if _TEST_TIMEOUT_S > 0 and hasattr(__import__("signal"), "SIGALRM"):
    import signal

    import pytest

    @pytest.hookimpl(hookwrapper=True)
    def pytest_runtest_call(item):
        def _alarm(signum, frame):
            raise TimeoutError(
                f"{item.nodeid} exceeded REPRO_TEST_TIMEOUT="
                f"{_TEST_TIMEOUT_S}s (SIGALRM test guard)")

        prev = signal.signal(signal.SIGALRM, _alarm)
        signal.alarm(_TEST_TIMEOUT_S)
        try:
            yield
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, prev)
