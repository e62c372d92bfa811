"""Mean of the engine's ``commit`` span, ms: the copy of the new KV to the
host, its encoding by the codec and the puts of the new chunk objects."""


def read(run):
    per = run.request_spans("commit")
    return sum(sum(v) for v in per.values()) / len(per) * 1e3 if per \
        else None
