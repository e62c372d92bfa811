"""Mean over requests of the engine's ``commit.d2h`` span, ms: the copy of
the new KV (the complete chunks' tokens, every layer) from the device into
pageable host memory."""


def read(run):
    per = run.request_spans("commit.d2h")
    return sum(sum(v) for v in per.values()) / len(per) * 1e3 if per \
        else None
