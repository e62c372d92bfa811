"""On the card: the traced run's reduction sees the device's work on the
host's clock."""
import time

import pytest
import torch

from ocbench import devtrace

pytestmark = pytest.mark.cuda


def test_profile_sees_device_work_on_the_host_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.randn(4096, 4096, device="cuda")
    a @ a
    torch.cuda.synchronize()
    prof = devtrace.Profile()
    prof.start()
    for _ in range(8):
        a = a @ a / 64
    torch.cuda.synchronize()
    time.sleep(0.05)  # an idle stretch
    prof.stop()
    prof.reduce()
    assert prof.device, "the profiler recorded no device activity"
    assert all(prof.t0 - 1e-3 <= t0 <= t1 <= prof.t1 + 1e-3
               for _, t0, t1 in prof.device)
    busy = devtrace.busy_s(prof.device, prof.t0, prof.t1)
    assert 0 < busy < prof.t1 - prof.t0 - 0.04
