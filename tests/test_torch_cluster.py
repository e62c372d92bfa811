"""The port's copies of the cluster simulator, fleet simulator, hybrid
policy/simulate and the observability modules the async engine reads.

Each copied file is the reference's line for line, imports rewritten
``repro.`` -> ``repro_torch.``; the port's `ClusterSim` and `FleetSim`
replay the committed golden traces to their expected tables at the
reference tests' tolerances (1e-9 absolute on times, 1e-12 on hit rates and
relative on bytes), and give records equal to the reference simulators' on
the same traces, field for field (the same Python arithmetic, so exact).
"""
import dataclasses
import inspect
import json
import os

import pytest

pytest.importorskip("torch")

import repro.cluster as ref_cluster  # noqa: E402
import repro.core.scheduler as ref_scheduler  # noqa: E402
import repro.fleet.sim as ref_fleet_sim  # noqa: E402
from repro.core.simulator import PAPER_MARGIN_BPS as REF_MARGIN  # noqa: E402
from repro.fleet.routing import make_router as ref_make_router  # noqa: E402
from repro_torch.cluster import ClusterSim, load_trace  # noqa: E402
from repro_torch.core.scheduler import Policy  # noqa: E402
from repro_torch.core.simulator import PAPER_MARGIN_BPS  # noqa: E402
from repro_torch.fleet import CacheConfig, FleetSim, make_router  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
GBPS = 1e9 / 8
MIXED32 = "mixed/" + "8" * 8 + "4" * 24 + "/g128"  # paper-geometry bit map

COPIED = [
    "cluster/__init__.py", "cluster/events.py", "cluster/metrics.py",
    "cluster/trace.py", "cluster/sim.py",
    "hybrid/__init__.py", "hybrid/policy.py", "hybrid/simulate.py",
    "obs/__init__.py", "obs/window.py", "obs/slo.py",
    "obs/critical_path.py", "obs/attribution.py", "obs/export.py",
    "obs/regress.py",
    "fleet/__init__.py", "fleet/routing.py", "fleet/workload.py",
    "fleet/sim.py",
]


@pytest.mark.parametrize("rel", COPIED)
def test_copy_is_the_reference_line_for_line(rel):
    """The port's file, ``repro_torch.`` written back as ``repro.``, equals
    the reference's: any other drift fails."""
    with open(os.path.join(ROOT, "src", "repro_torch", rel),
              encoding="utf-8") as f:
        port = f.read().replace("repro_torch.", "repro.").splitlines()
    with open(os.path.join(ROOT, "src", "repro", rel),
              encoding="utf-8") as f:
        ref = f.read().splitlines()
    assert len(port) == len(ref)
    for n, (a, b) in enumerate(zip(port, ref), 1):
        assert a == b, f"{rel}:{n}: {a!r} != {b!r}"


def _cluster_sims(name):
    """(port sim, reference sim) configured as the reference test of the
    golden trace ``name`` configures its sim."""
    kw = dict(cap_bps=50 * GBPS)
    extra = {"golden_trace.json": {},
             "golden_trace_mixed.json": {"codec": MIXED32}}[name]
    port = ClusterSim(policy=Policy.CAL_STALL_OPT,
                      margin_bps=PAPER_MARGIN_BPS, **kw, **extra)
    ref = ref_cluster.ClusterSim(policy=ref_scheduler.Policy.CAL_STALL_OPT,
                                 margin_bps=REF_MARGIN, **kw, **extra)
    return port, ref


def _fleet_sims():
    def mk(sim_mod, router):
        return sim_mod.FleetSim(
            2, router("affinity"),
            cache=sim_mod.CacheConfig(hot_capacity_bytes=2 * 1024 ** 3,
                                      policy="lru"),
            cap_bps=20 * GBPS, max_flows=8)

    import repro_torch.fleet.sim as port_fleet_sim
    return mk(port_fleet_sim, make_router), mk(ref_fleet_sim, ref_make_router)


GOLDEN = ["golden_trace.json", "golden_trace_mixed.json"]


class TestGoldenTraces:
    @pytest.mark.parametrize("name", GOLDEN)
    def test_cluster_sim_replays_expected_table(self, name):
        with open(os.path.join(DATA, name.replace(".json",
                                                  "_expected.json"))) as f:
            expected = json.load(f)
        port, _ = _cluster_sims(name)
        res = port.run(load_trace(os.path.join(DATA, name)))
        got = res.by_id()
        assert len(got) == len(expected["requests"])
        for row in expected["requests"]:
            r = got[row["req_id"]]
            for field in ("arrival_s", "admit_s", "flow_done_s",
                          "prefill_done_s", "ttft_s"):
                assert getattr(r, field) == pytest.approx(row[field],
                                                          abs=1e-9), \
                    (row["req_id"], field)
            if "bytes_total" in row:
                assert r.bytes_total == pytest.approx(row["bytes_total"],
                                                      rel=1e-12)
        assert res.reallocs == expected["reallocs"]
        assert res.events == expected["events"]

    def test_fleet_sim_replays_expected_table(self):
        with open(os.path.join(DATA,
                               "golden_trace_fleet_expected.json")) as f:
            expected = json.load(f)
        port, _ = _fleet_sims()
        res = port.run(load_trace(os.path.join(DATA,
                                               "golden_trace_fleet.json")))
        got = res.by_id()
        assert len(got) == len(expected["requests"])
        for row in expected["requests"]:
            r = got[row["req_id"]]
            assert r.node == row["node"], row["req_id"]
            assert r.hot_tokens == row["hot_tokens"], row["req_id"]
            assert r.hit_rate == pytest.approx(row["hit_rate"], abs=1e-12)
            assert r.ttft_s == pytest.approx(row["ttft_s"], abs=1e-9)
        assert res.global_chunks == expected["global_chunks"]
        assert res.shed == expected["shed"]


def _same_records(port_res, ref_res):
    """Every record field for field; ``repr`` keeps floats exact and makes
    the NaN of a never-set time compare equal to itself."""
    assert len(port_res.records) == len(ref_res.records)
    for a, b in zip(port_res.records, ref_res.records):
        assert repr(dataclasses.asdict(a)) == repr(dataclasses.asdict(b))


class TestSameRecordsAsReference:
    @pytest.mark.parametrize("name", GOLDEN)
    def test_cluster_sim(self, name):
        port, ref = _cluster_sims(name)
        a = port.run(load_trace(os.path.join(DATA, name)))
        b = ref.run(ref_cluster.load_trace(os.path.join(DATA, name)))
        _same_records(a, b)
        assert (a.reallocs, a.replans, a.events) == \
            (b.reallocs, b.replans, b.events)

    def test_fleet_sim(self):
        port, ref = _fleet_sims()
        path = os.path.join(DATA, "golden_trace_fleet.json")
        a = port.run(load_trace(path))
        b = ref.run(ref_cluster.load_trace(path))
        _same_records(a, b)
        assert (a.global_chunks, a.shed) == (b.global_chunks, b.shed)


def test_exports_match_reference():
    """The copied packages export the reference's names (FleetSim and its
    siblings through the lazy ``__getattr__``)."""
    import repro.fleet
    import repro.hybrid
    import repro.obs
    import repro_torch.cluster
    import repro_torch.fleet
    import repro_torch.hybrid
    import repro_torch.obs
    for port, ref in ((repro_torch.cluster, ref_cluster),
                      (repro_torch.fleet, repro.fleet),
                      (repro_torch.hybrid, repro.hybrid),
                      (repro_torch.obs, repro.obs)):
        assert port.__all__ == ref.__all__
        for name in port.__all__:
            obj = getattr(port, name)
            if inspect.isclass(obj) or inspect.isfunction(obj):
                assert obj.__module__.startswith("repro_torch."), name
    assert FleetSim is repro_torch.fleet.sim.FleetSim
    assert CacheConfig is repro_torch.fleet.sim.CacheConfig
