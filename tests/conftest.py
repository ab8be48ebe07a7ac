def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the port's hand-written kernels); each such "
        "test skips itself when torch.cuda.is_available() is false")
