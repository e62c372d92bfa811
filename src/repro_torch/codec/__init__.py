# KV wire-codec subsystem (DESIGN.md §Codec): pluggable transforms between
# model-dtype KV chunk slices and the bytes that live in the object store /
# cross the wire.  The identity codec is bit-exact; the quantized codecs trade
# bounded logit error for a 2-4x wire-byte reduction (CacheGen/LMCache-style):
# uniform int8/int4 (per-channel scales), gw8/gw4 (group-wise scales), and
# the variable-rate mixed-bit codec (per-layer bit allocation, codec/allocate
# calibration).
from .allocate import calibrate_mixed_codec, greedy_bit_map, layer_quant_error
from .base import (CODECS, FAMILY_BUILDERS, IdentityCodec, KVCodec,
                   codec_for_id, get_codec, register, register_family)
from .groupwise import GroupwiseCodec
from .mixedbit import MixedBitCodec, mixed_codec_name
from .quant import Int4Codec, Int8Codec
from .ref import (dequantize_grouped, dequantize_per_channel, pack_int4,
                  quantize_grouped, quantize_per_channel, unpack_int4)

__all__ = [
    "CODECS", "FAMILY_BUILDERS", "GroupwiseCodec", "IdentityCodec",
    "Int4Codec", "Int8Codec", "KVCodec", "MixedBitCodec",
    "calibrate_mixed_codec", "codec_for_id", "dequantize_grouped",
    "dequantize_per_channel", "get_codec", "greedy_bit_map",
    "layer_quant_error", "mixed_codec_name", "pack_int4", "quantize_grouped",
    "quantize_per_channel", "register", "register_family", "unpack_int4",
]
