"""Mean over requests of the engine's ``to_logits`` span, ms: from the
entry of ``submit`` to the last-token logits on the host, before the
commit; when a disaggregated prefill pool has its answer."""


def read(run):
    per = run.request_spans("to_logits")
    return sum(sum(v) for v in per.values()) / len(per) * 1e3 if per \
        else None
