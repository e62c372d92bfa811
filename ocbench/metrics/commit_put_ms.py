"""Mean over requests of the engine's ``commit.put`` span, ms: the index
insert of the prompt's chunks and the puts of the new chunk objects."""


def read(run):
    per = run.request_spans("commit.put")
    return sum(sum(v) for v in per.values()) / len(per) * 1e3 if per \
        else None
