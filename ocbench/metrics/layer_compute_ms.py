"""Mean over requests of the engine's ``compute`` spans summed per request,
ms: the layer steps of a hit (one span each) or a cold prefill (one
span)."""


def read(run):
    per = run.request_spans("compute")
    return sum(sum(v) for v in per.values()) / len(per) * 1e3 if per \
        else None
