"""Seconds from the start of the run's process to the end of warm-up:
weights, kernels (built into the checkout on its first run), the store's
fill and the warm-up requests."""


def read(run):
    return run.setup_s
