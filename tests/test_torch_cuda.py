"""The port's CUDA kernels on the card, bit for bit against their plain
PyTorch versions.  Imports no JAX, so it runs on a machine with a GPU and
without the reference's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every case skips."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import kv_dequant as K  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")


def _inputs(seed, N, R, W, group, packed):
    rng = np.random.default_rng(seed)
    if packed:
        q = rng.integers(0, 256, size=(N, R, W // 2), dtype=np.uint8)
    else:
        q = rng.integers(-128, 128, size=(N, R, W), dtype=np.int8)
    s = rng.standard_normal((N, W // group)).astype(np.float16)
    return torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape,group", [
    ((15, 256, 1024), 1), ((15, 256, 1024), 128), ((3, 5, 24), 8),
    ((1, 3, 1030), 2), ((2, 3, 20), 4)])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
def test_bit_equal(packed, shape, group, out):
    q, s = _inputs(7, *shape, group, packed)
    kern = K.kv_dequant_packed4 if packed else K.kv_dequant
    plain = K.kv_dequant_packed4_ref if packed else K.kv_dequant_ref
    before = K.LAUNCHES[kern.__name__]
    got = kern(q, s, group=group, out_dtype=out)
    torch.cuda.synchronize()
    assert K.LAUNCHES[kern.__name__] == before + 1
    assert torch.equal(got, plain(q, s, group=group, out_dtype=out))


def test_kernel_rejects_non_contiguous():
    q, _ = _inputs(8, 2, 4, 64, 1, False)
    q_t = q.transpose(1, 2)  # [2, 64, 4], not contiguous
    s = torch.ones((2, 4), dtype=torch.float16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        K.kv_dequant(q_t, s)
