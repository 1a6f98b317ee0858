"""The benchmark's own tests: on the CPU at toy widths, except those
marked ``card``, which need an NVIDIA card and skip inside the test
without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without "
        "one")
