import os
import sys

# Tests run on the single host CPU device (the dry-run, and only the dry-run,
# forces 512 placeholder devices in its own process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU with nvcc; skips without one")
