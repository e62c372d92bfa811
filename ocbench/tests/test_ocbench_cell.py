"""The harness's cell function at the two configurations' smoke sizes on the
CPU: held to the reference it is correct; with the timed path broken
underneath it is not; and the control (the reference in fp8 in the
program's place) fails the limit.

The faults a served cell can have: a step that returns its state unchanged,
an answer altered where it is produced, and a commit left out.  A request
is one sequence on one chip, so no half of a batch and no exchange between
chips can be left out."""
import numpy as np
import pytest
import torch

from ocbench import harness
from ocbench.control import control_reading
from ocbench.tests.smoke import DENSE, MOE, SHARED, UNSHARED, cell
from repro_torch.models import dense, moe
from ocbench.traffic import schedule
from repro_torch.serving import ServingEngine

SEED = 2**31 + 5
CELLS = {"dense-shared": (DENSE, SHARED), "moe-shared": (MOE, SHARED),
         "dense-unshared": (DENSE, UNSHARED)}


def run(name, trace=False, seconds=2.0, **mix):
    c = cell(*CELLS[name])
    c.mix.update(mix)
    return harness.run_cell(c, SEED, seconds, trace, "cpu")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_correct_against_the_reference(name):
    out = run(name)
    assert out["correct"], out["checks"]
    # what a loaded CPU reaches in the window; the rest is shed
    assert 0 < out["attempted"] <= len(schedule(CELLS[name][1], 2.0))
    assert out["failed"] == 0
    assert out["checks"]["logit_gap"][0] <= 1e-4
    assert out["checks"]["logit_rel_err"][0] <= 1e-5
    assert set(out["metrics"]) == {"served_tok_s", "setup_s"}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_above_capacity_sheds_what_has_not_started(name):
    mix = dict(rate_rps=4000.0)
    out = run(name, seconds=0.3, **mix)
    due = len(schedule(dict(CELLS[name][1], **mix), 0.3))
    assert out["correct"], out["checks"]
    assert 0 < out["attempted"] < due and out["failed"] == 0
    assert out["metrics"]["served_tok_s"]["value"] > 0


def test_traced_run_reads_its_layers():
    out = run("dense-shared", trace=True)
    assert out["correct"]
    m = out["metrics"]
    for name in ("layer_compute_ms", "commit_ms", "prefill_mfu_pct"):
        assert m[name]["value"] > 0, name
    # no device on the CPU: nothing to read, nothing reported
    assert "device_idle_pct" not in m
    assert out["breakdown"]["idle_gaps"]


def _stale_steps(monkeypatch):
    """Every layer step returns its input unchanged."""
    block, packed, moe_block = dense.block, dense.block_packed, moe.moe_block

    def stale(fn, n_out):
        def wrapped(p, cfg, x, *a, **k):
            out = fn(p, cfg, x, *a, **k)
            return (x,) + tuple(out[1:n_out])
        return wrapped
    monkeypatch.setattr(dense, "block", stale(block, 2))
    monkeypatch.setattr(dense, "block_packed", stale(packed, 2))
    monkeypatch.setattr(moe, "moe_block", stale(moe_block, 3))


def _altered_answer(monkeypatch):
    """The token the logits put first is moved to the last place."""
    host = ServingEngine._host_logits

    def altered(self, lg):
        out = host(self, lg).copy()
        V = self.cfg.vocab_size
        out[int(np.argmax(out[:V]))] = out[:V].min() - 1.0
        return out
    monkeypatch.setattr(ServingEngine, "_host_logits", altered)


def _no_commit(monkeypatch):
    monkeypatch.setattr(ServingEngine, "_commit", lambda self, *a, **k: None)


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("fault,fails", [
    (_stale_steps, "logit_rel_err"), (_altered_answer, "logit_gap"),
    (_no_commit, "objects_missing")])
def test_a_broken_path_is_not_correct(monkeypatch, name, fault, fails):
    fault(monkeypatch)
    out = run(name)
    value, limit = out["checks"][fails]
    assert not out["correct"] and value > limit, out["checks"]
    if fault is _no_commit and CELLS[name][1]["prefixes"]:
        # nothing was stored, so no hit was fetched
        assert out["checks"]["fetch_bytes_missing"][0] > 0


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_control_fails_the_limit(name):
    """Judged by the check's own comparison at the positions it compares."""
    c = cell(*CELLS[name])
    with torch.no_grad():
        got = [control_reading(c, s, 0.5, "cpu")["logit_rel_err"]
               for s in (1, 2, 3)]
    assert min(got) > 30 * c.limits["logit_rel_err"], got
