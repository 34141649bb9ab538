import os
import sys

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see
# the real single CPU device; multi-device tests spawn subprocesses that
# set --xla_force_host_platform_device_count themselves.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MD_SCRIPTS = os.path.join(REPO, "tests", "md_scripts")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where there is none")
