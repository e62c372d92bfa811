import os
import sys

try:
    import hypothesis  # noqa: F401
except ImportError:  # container has no hypothesis and pip is off-limits
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _hypothesis_stub
    _hypothesis_stub.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (an NVIDIA H100); skips "
        "without one")
