import os

# Tests run on the single host CPU device except the explicitly marked
# multi-device tests, which spawn their own subprocess-free 8-device setup
# via this env knob BEFORE jax initializes.  (The dry-run sets 512 in its
# own process; never here.)
if os.environ.get("REPRO_TEST_DEVICES"):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count="
        f"{os.environ['REPRO_TEST_DEVICES']}")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one "
        "(run on the card with `pytest -m gpu`)")
