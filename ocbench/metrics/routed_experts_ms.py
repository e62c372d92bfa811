"""Mean over requests of the engine's ``compute.experts`` spans summed per
request, ms: each MoE layer's routed experts (router, dispatch, grouped
products and combine; the shared experts aside), between two CUDA events
on the device's stream.  Where the step is bound by the host's enqueue, as
a warm layer step over a short suffix is, the device waits between the
region's launches and the span holds that wait: it then reads the host's
time to enqueue the experts more than their device work, and a change that
only shortens the experts' kernels will not move it."""


def read(run):
    per = run.request_spans("compute.experts")
    return sum(sum(v) for v in per.values()) / len(per) * 1e3 if per \
        else None
