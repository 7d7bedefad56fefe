"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the ``chip`` marker for the tests that need an NVIDIA
GPU, which decide inside the test that there is none and skip."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU (skips without one)")
