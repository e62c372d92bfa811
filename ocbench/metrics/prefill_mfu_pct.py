"""The whole prefill's share of the H100's bf16 peak, %: useful FLOPs of
every finished request (``counts.prefill_flops`` of its reused prefix and
its computed tokens) over the summed wall time of its ``submit``."""
from ocbench.counts import H100_BF16_FLOPS, prefill_flops


def read(run):
    done = [s for s in run.served if s.ok]
    if not done:
        return None
    flops = sum(prefill_flops(run.cfg, s.matched, s.req.prompt_len
                              - s.matched) for s in done)
    wall = sum(s.end - s.start for s in done)
    return 100.0 * flops / wall / H100_BF16_FLOPS
