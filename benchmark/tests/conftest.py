"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``cuda`` that run the controls at the cells' own sizes on the card (they
skip without one)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the cells' own sizes); skips without one")
