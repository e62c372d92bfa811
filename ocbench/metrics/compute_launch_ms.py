"""Mean over requests of the engine's ``compute.launch`` spans summed per
request, ms: from the start of each ``compute`` span to the return of the
model step's call, before the wait for the device; the host's enqueue
time."""


def read(run):
    per = run.request_spans("compute.launch")
    return sum(sum(v) for v in per.values()) / len(per) * 1e3 if per \
        else None
