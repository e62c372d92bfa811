"""Each metric reader on a synthetic run: spans, requests and device
activity set by hand."""
import pytest

from ocbench import devtrace, harness
from ocbench.harness import RunRecord, Served, load_reader
from ocbench.tests.smoke import DENSE, METRICS
from ocbench.traffic import Request


class Span:
    def __init__(self, track, name, t0, t1):
        self.track, self.name, self.t0, self.t1 = track, name, t0, t1


class Prof:
    def __init__(self, device, t0, t1):
        self.device, self.t0, self.t1 = device, t0, t1


def run(profile=None):
    # window of 10 s from t=100; r0 a hit on a 32-token prefix, r1 cold,
    # r2 failed
    reqs = [Request(0, 0.0, 0, 32, 8), Request(1, 1.0, -1, 0, 16),
            Request(2, 2.0, 1, 48, 4)]
    served = [Served(reqs[0], 100.0, 100.5, 101.0, matched=32),
              Served(reqs[1], 101.0, 101.0, 101.25, matched=0),
              Served(reqs[2], 102.0, 102.0, None, error="boom")]
    spans = [Span("r0", "fetch", 100.5, 100.6),
             Span("r0", "dequant", 100.6, 100.61),
             Span("r0", "dequant", 100.62, 100.65),
             Span("r0", "compute", 100.7, 100.8),
             Span("r0", "compute", 100.8, 100.85),
             Span("r0/model", "compute", 0.0, 5.0),  # virtual clock
             Span("r0", "commit", 100.9, 101.0),
             Span("r1", "compute", 101.0, 101.2),
             Span("r1", "commit", 101.2, 101.25),
             Span("fill0", "compute", 1.0, 2.0)]
    return RunRecord(dict(DENSE), 10.0, 42.0, 100.0, served, spans, profile)


def value(name, r=None):
    return load_reader(name)(r or run())


def test_every_metric_has_a_reader():
    for name in METRICS:
        assert callable(load_reader(name))


def test_served_tokens_leave_out_a_failure():
    assert value("setup_s") == 42.0
    assert value("served_tok_s") == pytest.approx((40 + 16) / 10.0)


def test_served_tokens_count_the_request_at_the_close_by_its_share():
    r = run()
    late = Request(3, 9.0, -1, 0, 30)
    r.served += [Served(late, 109.0, 109.5, 110.5),  # half inside
                 Served(Request(4, 9.5, -1, 0, 99), 109.5)]  # shed
    assert value("served_tok_s", r) == pytest.approx((40 + 16 + 15) / 10.0)


def test_span_readers():
    assert value("layer_compute_ms") == pytest.approx((150 + 200) / 2)
    assert value("commit_ms") == pytest.approx((100 + 50) / 2)


def test_prefill_mfu_by_hand():
    from ocbench.counts import prefill_flops
    flops = prefill_flops(DENSE, 32, 8) + prefill_flops(DENSE, 0, 16)
    assert value("prefill_mfu_pct") == pytest.approx(
        100 * flops / 0.75 / 989e12)


def test_device_idle_reads_nothing_without_a_trace():
    assert value("device_idle_pct") is None


def test_device_idle_counts_overlapping_work_once():
    ops = [("gemm", 100.6, 100.65), ("gemm", 100.64, 100.66),
           ("attn", 100.7, 100.75)]
    r = run(Prof(ops, 100.4, 101.4))
    assert value("device_idle_pct", r) == pytest.approx(100 * (1 - 0.11))


def test_idle_gaps_by_host_span():
    ops = [("a", 1.0, 2.0), ("b", 1.5, 3.0), ("c", 5.0, 6.0)]
    assert devtrace.busy_intervals(ops, 0.0, 10.0) == [(1.0, 3.0),
                                                       (5.0, 6.0)]
    gaps = devtrace.idle_gaps(ops, 0.0, 7.0)
    assert gaps == [(0.0, 1.0), (3.0, 5.0), (6.0, 7.0)]
    got = dict(devtrace.idle_by_host(gaps, [("fetch", [(0.5, 1.5)]),
                                            ("submit", [(0.0, 4.0)])]))
    assert got == pytest.approx({"fetch": 0.5, "submit": 1.5, "other": 2.0})
    top = devtrace.top_device_ops(ops)
    assert top[0][0] == "a" or top[0][0] == "b"
    assert sum(t for _, t in top) == pytest.approx(3.5)


def test_breakdown_names_the_host_span():
    r = run(Prof([("gemm", 100.7, 100.85)], 100.5, 101.0))
    bd = harness.breakdown(r)
    assert bd["device_ops"] == [["gemm", pytest.approx(0.15)]]
    idle = dict(bd["idle_gaps"])
    assert idle["fetch"] == pytest.approx(0.1)
    assert idle["commit"] == pytest.approx(0.1)

