"""The commit's encode (K9): `kernels.kv_encode` and the commit path over it.

On the CPU: the plain version writes the bytes of the port's numpy codec
and of the reference's (`repro.codec`), for every quantized codec, from
bf16 and fp32 caches, at a nonzero batch row and start token; on edge
chunks (an all-zero channel, an absmax above qmax x 65504, values at exact
half-steps of the scale, values at -qmax); the arguments it refuses; and
`encode_plan`'s coverage of every channel and row.  On the card (`cuda`
marker; this file imports no JAX at module level, so it runs there): the
kernel bit-equal to the plain version at the serving shape, on the edge
chunks and through a commit, which adds to the launch count.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kv_encode.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.codec import (get_codec, mixed_codec_name,  # noqa: E402
                               unpack_int4)
from repro_torch.core import KVSpec  # noqa: E402
from repro_torch.kernels import kv_encode as E  # noqa: E402
from repro_torch.kernels import launches, ops  # noqa: E402
from repro_torch.serving import kv_chunks  # noqa: E402

CODECS = ["int8", "int4", "gw8/g16", "gw4/g16", "mixed/84/g16"]
DTYPES = [torch.float32, torch.bfloat16]
G = 8
L, KV, DH = 2, 2, 16  # width 32


def _spec(codec, dtype, layers=L, chunk=G, kv=KV, dh=DH):
    return KVSpec(layers, chunk, kv, dh,
                  dtype_bytes=torch.empty((), dtype=dtype).element_size(),
                  codec=codec)


def _layer_params(spec):
    codec = get_codec(spec.codec)
    layers = range(spec.num_layers)
    return ([codec.layer_bits(spec, l) for l in layers],
            [codec.layer_group(spec, l) for l in layers])


def _cache(seed, dtype, layers=L, batch=2, tokens=5 * G, kv=KV, dh=DH,
           device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(layers, 2, batch, tokens, kv, dh, generator=g,
                    device=device) * 3
    return x.to(dtype)


def _numpy_objects(encode_chunk, cache, spec, n, batch_row, start):
    """The numpy codec's bytes of n chunks of ``cache`` (fp32 values)."""
    W = spec.width
    out = []
    for i in range(n):
        t0 = start + i * spec.chunk_tokens
        sl = cache[:, :, batch_row, t0:t0 + spec.chunk_tokens].float()
        a = sl.reshape(spec.num_layers, 2, spec.chunk_tokens, W).numpy()
        out.append(encode_chunk(a[:, 0], a[:, 1], spec))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("codec", CODECS)
def test_plain_version_writes_the_codecs_bytes(codec, dtype):
    from repro.codec import get_codec as ref_get_codec
    from repro.core.types import KVSpec as RefKVSpec

    spec = _spec(codec, dtype)
    ref_spec = RefKVSpec(L, G, KV, DH, dtype_bytes=spec.dtype_bytes,
                         codec=codec)
    cache = _cache(11, dtype)
    bits, groups = _layer_params(spec)
    x = cache[:, :, 1, 5:5 + 3 * G]  # batch row 1, from token 5
    got = E.kv_quant_encode_ref(x, chunk_tokens=G, bits=bits, groups=groups)
    assert got.shape == (3, spec.wire_chunk_bytes)
    assert E.wire_offsets(G, spec.width, bits, groups) \
        == list(spec.wire_layer_offsets)
    want = _numpy_objects(get_codec(codec).encode_chunk, cache, spec, 3, 1, 5)
    ref = _numpy_objects(
        lambda k, v, s: ref_get_codec(codec).encode_chunk(k, v, ref_spec),
        cache, spec, 3, 1, 5)
    assert ref == want
    assert [bytes(row.numpy()) for row in got] == want
    # the op takes the plain version for a CPU tensor
    assert torch.equal(ops.kv_quant_encode_op(x, chunk_tokens=G, bits=bits,
                                              groups=groups), got)


def _edge_cache(case, bits, dtype):
    """[1, 2, 1, G, KV, dh] with one chunk built for ``case``."""
    qmax = (1 << (bits - 1)) - 1
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 2, 1, G, KV, DH)).astype(np.float32)
    flat = x.reshape(1, 2, 1, G, KV * DH)
    if case == "zero_channel":
        flat[..., 3] = 0.0
        flat[..., 17] = -0.0
    elif case == "above_fp16_scale":
        flat[0, 0, 0, 2, 5] = qmax * 65504.0 * 4  # the scale caps at 65504
        flat[0, 1, 0, 6, 9] = -qmax * 65504.0 * 1.5
    elif case == "half_steps":
        # channel c: absmax qmax * 0.5 (the scale 0.5, exact in fp16), the
        # other values on half-steps k + 0.5 of it
        steps = rng.integers(-qmax, qmax, size=flat.shape) + 0.5
        flat[...] = steps * 0.5
        flat[..., 0, :] = qmax * 0.5
    elif case == "at_minus_qmax":
        flat[..., 1, :] = -np.abs(flat).max(axis=-2) - 1.0
    return torch.from_numpy(x).to(dtype)


EDGE_CASES = ["zero_channel", "above_fp16_scale", "half_steps",
              "at_minus_qmax"]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("case", EDGE_CASES)
def test_plain_version_on_edge_chunks(case, codec):
    spec = _spec(codec, torch.float32, layers=1 if "mixed" not in codec
                 else 2)
    bits, groups = _layer_params(spec)
    cache = torch.cat([_edge_cache(case, b, torch.float32) for b in bits])
    x = cache[:, :, 0]
    got = E.kv_quant_encode_ref(x, chunk_tokens=G, bits=bits, groups=groups)
    want = _numpy_objects(get_codec(codec).encode_chunk, cache, spec, 1, 0, 0)
    assert bytes(got[0].numpy()) == want[0]
    if case == "half_steps" and groups[0] == 1:
        # round half to even: k + 0.5 of the scale codes to the even one
        q, _ = get_codec(codec).parse_layer_payload(
            want[0][:spec.wire_layer_bytes(0)], 1, spec, 0)
        if bits[0] == 4:
            q = unpack_int4(q)
        vals = x[0].reshape(2 * G, -1).numpy() / 0.5
        assert (np.abs(vals - np.trunc(vals)) == 0.5).any()
        assert np.array_equal(q[0], np.rint(vals).astype(np.int8))


def test_plain_version_on_an_fp16_scale_cap():
    """An absmax above qmax x 65504 stores the largest fp16 scale, and its
    value codes to qmax (clipped), not to inf or NaN."""
    spec = _spec("int8", torch.float32, layers=1)
    cache = _edge_cache("above_fp16_scale", 8, torch.float32)
    got = E.kv_quant_encode_ref(cache[:, :, 0], chunk_tokens=G, bits=[8],
                                groups=[1])
    q, scales = get_codec("int8").parse_layer_payload(
        bytes(got[0].numpy()), 1, spec, 0)
    assert scales[0, 0, 5] == np.float16(65504.0)
    assert scales[0, 1, 9] == np.float16(65504.0)
    assert q[0, 2, 5] == 127 and q[0, G + 6, 9] == -127


def _bad(name):
    x = torch.zeros(2, 2, 2 * G, KV, DH)
    ok = dict(chunk_tokens=G, bits=[8, 8], groups=[1, 1])
    return {
        "fp16": (torch.zeros(2, 2, 2 * G, KV, DH, dtype=torch.float16), ok,
                 TypeError),
        "int8": (torch.zeros(2, 2, 2 * G, KV, DH, dtype=torch.int8), ok,
                 TypeError),
        "4d": (torch.zeros(2, 2, 2 * G, KV * DH), ok, ValueError),
        "three_matrices": (torch.zeros(2, 3, 2 * G, KV, DH), ok, ValueError),
        "ragged_tokens": (torch.zeros(2, 2, 2 * G + 1, KV, DH), ok,
                          ValueError),
        "no_tokens": (torch.zeros(2, 2, 0, KV, DH), ok, ValueError),
        "bits_per_layer": (x, dict(ok, bits=[8]), ValueError),
        "bits_2": (x, dict(ok, bits=[8, 2]), ValueError),
        "group_not_dividing": (x, dict(ok, groups=[1, 3]), ValueError),
    }[name]


@pytest.mark.parametrize("fn", [E.kv_quant_encode_ref, E.kv_quant_encode],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("name", ["fp16", "int8", "4d", "three_matrices",
                                  "ragged_tokens", "no_tokens",
                                  "bits_per_layer", "bits_2",
                                  "group_not_dividing"])
def test_refuses(fn, name):
    x, kw, err = _bad(name)
    with pytest.raises(err):
        fn(x, **kw)


def test_kernel_refuses_a_cpu_tensor():
    x = torch.zeros(2, 2, 2 * G, KV, DH)
    with pytest.raises(ValueError, match="CUDA"):
        E.kv_quant_encode(x, chunk_tokens=G, bits=[8, 8], groups=[1, 1])


@pytest.mark.parametrize("G_, W, groups", [
    (256, 1024, [1] * 40), (256, 1024, [128] * 40), (256, 1024, [16, 1]),
    (256, 512, [256]), (256, 1024, [1024]), (8, 32, [16, 16]),
    (8, 16, [1, 2]), (100, 192, [3, 64]), (1, 24, [24]), (512, 2048, [8])])
def test_plan_covers_every_channel_and_row(G_, W, groups):
    plan = E.encode_plan(G_, W, groups)
    assert plan.threads <= E.ENCODE_MAX_THREADS
    assert plan.strip % math.lcm(E.ENCODE_UNIT, *groups) == 0
    nx, ny, nz = plan.grid(W, 3, 2)
    assert (ny, nz) == (6, 2)
    units = plan.strip // E.ENCODE_UNIT
    channels = [b * plan.strip + cx * E.ENCODE_UNIT + j
                for b in range(nx) for cx in range(units)
                for j in range(E.ENCODE_UNIT)]
    assert sorted(c for c in channels if c < W) == list(range(W))
    rows = [r for ry in range(plan.row_groups) for r in plan.rows_of(ry, G_)]
    assert sorted(rows) == list(range(G_))
    # every group inside one strip
    assert all((c // g) * g // plan.strip == c // plan.strip
               for g in groups for c in range(W))


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        E.encode_plan(256, 1020, [1])
    with pytest.raises(ValueError):
        E.encode_plan(256, 4096, [4096])


# -- on the card ------------------------------------------------------------

SERVING = dict(layers=40, kv=8, dh=128, chunk=256)


def _serving_codecs():
    """Every quantized codec at the serving depth (a 40-layer bit map)."""
    return ["int8", "int4", "gw8/g16", "gw4/g16",
            mixed_codec_name([8, 4] * 20, 16)]


@pytest.fixture
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("codec_i", range(5))
def test_kernel_bit_equal_at_the_serving_shape(_card, codec_i, n, dtype):
    codec = _serving_codecs()[codec_i]
    spec = KVSpec(SERVING["layers"], SERVING["chunk"], SERVING["kv"],
                  SERVING["dh"], dtype_bytes=2, codec=codec)
    bits, groups = _layer_params(spec)
    G_ = spec.chunk_tokens
    cache = _cache(3 + n, dtype, layers=spec.num_layers, batch=2,
                   tokens=(n + 1) * G_, kv=SERVING["kv"], dh=SERVING["dh"],
                   device="cuda")
    x = cache[:, :, 1, G_:(n + 1) * G_]
    before = launches.LAUNCHES["kv_quant_encode"]
    got = E.kv_quant_encode(x, chunk_tokens=G_, bits=bits, groups=groups)
    assert launches.LAUNCHES["kv_quant_encode"] == before + 1
    want = E.kv_quant_encode_ref(x, chunk_tokens=G_, bits=bits,
                                 groups=groups)
    torch.cuda.synchronize()
    assert got.shape == (n, spec.wire_chunk_bytes)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("case", EDGE_CASES)
def test_kernel_bit_equal_on_edge_chunks(_card, case, codec):
    spec = _spec(codec, torch.float32,
                 layers=1 if "mixed" not in codec else 2)
    bits, groups = _layer_params(spec)
    cache = torch.cat([_edge_cache(case, b, torch.float32) for b in bits])
    x = cache[:, :, 0].cuda()
    got = E.kv_quant_encode(x, chunk_tokens=G, bits=bits, groups=groups)
    want = E.kv_quant_encode_ref(x.cpu(), chunk_tokens=G, bits=bits,
                                 groups=groups)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["identity"] + CODECS)
def test_a_cuda_commit_stores_the_plain_bytes(_card, codec):
    """`cache_to_chunks` on a CUDA cache: the CPU commit's bytes, and one K9
    launch for a quantized codec (none for identity)."""
    spec = _spec(codec, torch.bfloat16)
    cache = _cache(9, torch.bfloat16)
    keys = [bytes([i]) * 4 for i in range(3)]
    want = kv_chunks.cache_to_chunks(cache, keys, spec, batch_row=1,
                                     start_token=5)
    before = launches.LAUNCHES["kv_quant_encode"]
    got = kv_chunks.cache_to_chunks(cache.cuda(), keys, spec, batch_row=1,
                                    start_token=5)
    lossless = get_codec(codec).lossless
    assert launches.LAUNCHES["kv_quant_encode"] == before + (not lossless)
    assert got == want
