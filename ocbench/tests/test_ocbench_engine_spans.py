"""The readers of the engine's spans inside ``commit`` and ``compute`` and
of ``to_logits``: on spans set by hand, then on a traced run of the dense
smoke cell on the CPU."""
import json

import pytest

from ocbench import harness
from ocbench.harness import ROOT, RunRecord, Served, load_reader
from ocbench.tests.smoke import DENSE, UNSHARED, cell
from ocbench.traffic import Request

SEED = 2**31 + 11
NEW = ["commit_d2h_ms", "commit_encode_ms", "commit_put_ms",
       "compute_launch_ms", "to_logits_ms"]


class Span:
    def __init__(self, track, name, t0, t1):
        self.track, self.name, self.t0, self.t1 = track, name, t0, t1


def run(spans):
    reqs = [Request(0, 0.0, -1, 0, 16), Request(1, 1.0, -1, 0, 32)]
    served = [Served(reqs[0], 100.0, 100.0, 100.5),
              Served(reqs[1], 101.0, 101.0, 101.25)]
    return RunRecord(dict(DENSE), 10.0, 1.0, 100.0, served, spans, None)


def by_hand():
    # r0: two layer steps and one commit; r1: one prefill and one commit;
    # a virtual-clock track and set-up requests are left out
    return run([
        Span("r0", "to_logits", 100.0, 100.3),
        Span("r0", "compute.launch", 100.1, 100.12),
        Span("r0", "compute.launch", 100.2, 100.23),
        Span("r0", "commit.d2h", 100.31, 100.33),
        Span("r0", "commit.encode", 100.33, 100.43),
        Span("r0", "commit.put", 100.43, 100.44),
        Span("r0/model", "compute.launch", 0.0, 5.0),
        Span("r1", "to_logits", 101.0, 101.1),
        Span("r1", "compute.launch", 101.01, 101.06),
        Span("r1", "commit.d2h", 101.1, 101.14),
        Span("r1", "commit.encode", 101.14, 101.2),
        Span("r1", "commit.put", 101.2, 101.23),
        Span("fill0", "commit.encode", 1.0, 9.0),
        Span("warm0", "to_logits", 1.0, 9.0)])


@pytest.mark.parametrize("name,want", [
    ("commit_d2h_ms", (20 + 40) / 2), ("commit_encode_ms", (100 + 60) / 2),
    ("commit_put_ms", (10 + 30) / 2),
    ("compute_launch_ms", (20 + 30 + 50) / 2),
    ("to_logits_ms", (300 + 100) / 2)])
def test_reader_by_hand(name, want):
    assert load_reader(name)(by_hand()) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing_without_its_span(name):
    """A program without the span (the parent of the change that adds it):
    no reading, no error."""
    old = [s for s in by_hand().spans if s.name in ("commit", "compute")]
    assert load_reader(name)(run(old)) is None
    assert load_reader(name)(run([])) is None


@pytest.mark.parametrize("name", NEW)
def test_the_benchmark_lists_the_metric(name):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = next(m for m in bench["per_layer"] if m["name"] == name)
    assert m["source"] == "program_span" and m["moves"] == "served_tok_s"
    assert m["workloads"] == ["qwen3-14b.unshared-short.saturated"]


def test_traced_run_reads_the_parts():
    c = cell(DENSE, UNSHARED)
    c.metrics += [{"name": n, "unit": "ms", "kind": "per_layer"}
                  for n in NEW]
    out = harness.run_cell(c, SEED, 2.0, True, "cpu")
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    for name in NEW:
        assert m[name] > 0, name
    parts = m["commit_d2h_ms"] + m["commit_encode_ms"] + m["commit_put_ms"]
    assert parts <= m["commit_ms"]
    assert m["compute_launch_ms"] <= m["layer_compute_ms"]
    assert m["layer_compute_ms"] <= m["to_logits_ms"]


class Prof:
    def __init__(self, device, t0, t1):
        self.device, self.t0, self.t1 = device, t0, t1


def test_breakdown_gives_idle_to_the_parents_first():
    """An idle moment goes to the first covering name in sorted order:
    inside a part of ``commit`` or ``compute`` to the parent, and to
    ``to_logits`` only where no other engine span covers it."""
    r = by_hand()
    r.spans += [Span("r0", "compute", 100.1, 100.15),
                Span("r0", "commit", 100.31, 100.45)]
    # the device busy from 100.0 to 100.32 but for three gaps: in a layer
    # step's launch (100.11-100.12), between steps (100.16-100.19, only
    # `to_logits` covers it) and in the commit's copy (100.31-100.32)
    busy = [("k", 100.0, 100.11), ("k", 100.12, 100.16),
            ("k", 100.19, 100.31)]
    r.profile = Prof(busy, 100.0, 100.32)
    idle = dict(harness.breakdown(r)["idle_gaps"])
    assert idle == pytest.approx({"compute": 0.01, "to_logits": 0.03,
                                  "commit": 0.01})
