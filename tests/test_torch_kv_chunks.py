"""`serving.kv_chunks.PackedLayerKV` against the reference's on the same
wire payloads: its public properties (`tokens`, `resident_bytes`) and
fields equal the reference's for every codec with a packed form, at every
layer and chunk count."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.codec import get_codec as ref_get_codec  # noqa: E402
from repro.core import KVSpec as RefKVSpec, layer_range  # noqa: E402
from repro.serving import kv_chunks as ref_kv  # noqa: E402
from repro_torch.core import KVSpec  # noqa: E402
from repro_torch.serving import PackedLayerKV, kv_chunks  # noqa: E402


@pytest.mark.parametrize("N", [1, 3])
@pytest.mark.parametrize("codec_name", ["int8", "int4", "gw8/g32",
                                        "gw4/g32", "mixed/84/g32"])
def test_packed_layer_kv_matches_reference(codec_name, N):
    codec = ref_get_codec(codec_name)
    L, KV, dh, G = 2, 2, 32, 8
    geo = dict(num_layers=L, chunk_tokens=G, num_kv_heads=KV, head_dim=dh,
               dtype_bytes=2, codec=codec_name)
    ref_spec, spec = RefKVSpec(**geo), KVSpec(**geo)
    rng = np.random.default_rng(N)
    bufs = [codec.encode_chunk(
        rng.standard_normal((L, G, ref_spec.width)).astype(np.float32),
        rng.standard_normal((L, G, ref_spec.width)).astype(np.float32),
        ref_spec) for _ in range(N)]
    for layer in range(L):
        lo, hi = layer_range(layer, ref_spec)
        payload = b"".join(b[lo:hi] for b in bufs)
        want = ref_kv.layer_payload_to_packed_kv(payload, N, ref_spec,
                                                 layer=layer)
        got = kv_chunks.layer_payload_to_packed_kv(payload, N, spec,
                                                   layer=layer, device="cpu")
        assert isinstance(got, PackedLayerKV)
        assert got.tokens == want.tokens == N * G
        assert got.resident_bytes == want.resident_bytes
        assert (got.bits, got.group, got.chunk_tokens) == \
            (want.bits, want.group, want.chunk_tokens)
