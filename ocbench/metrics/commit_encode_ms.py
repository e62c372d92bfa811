"""Mean over requests of the engine's ``commit.encode`` span, ms: the
codec's encode of the new chunks on the host (bf16 widened to fp32, then
``codec.encode_chunk`` a chunk)."""


def read(run):
    per = run.request_spans("commit.encode")
    return sum(sum(v) for v in per.values()) / len(per) * 1e3 if per \
        else None
