def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (an NVIDIA H100); skips "
        "without one")
