import os

# Tests run on a virtual 8-device CPU mesh unless JAX_PLATFORMS names
# another platform (tests marked `gpu` need JAX_PLATFORMS=cuda and a card).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (JAX_PLATFORMS=cuda); skips "
        "elsewhere and runs in phase (f) of chip_smoke.py")
