"""Mean over requests of the engine's ``compute.expand`` spans summed per
request, ms: each layer's up-projection of the fetched prefix latent to
per-head keys and values (latent attention), between two CUDA events on
the device's stream (on an enqueue-bound step, the device's wait for the
region's launches included, as in ``routed_experts_ms``)."""


def read(run):
    per = run.request_spans("compute.expand")
    return sum(sum(v) for v in per.values()) / len(per) * 1e3 if per \
        else None
