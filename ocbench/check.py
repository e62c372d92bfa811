"""What decides ``correct``: every number compared, each beside its limit
(``limits/<cell>.json``).

Over a sample of the window's finished requests, drawn from the seed with
the longest in it, the program's last-token logits are set beside the
reference's (the architecture's module under ``reference/``, fp32, which
recomputes every shared prefix from the same weights and tokens and passes
its K and V through its own copy of the codec, as the fetched prefix
does):

- ``logit_rel_err``: the largest relative distance ||served - reference|| /
  ||reference|| of a sampled request's logits over the vocabulary.
- ``logit_gap``: the widest gap by which the reference's logit of the token
  the served logits put first lies below the reference's best.

And, from the run's own counts:

- ``fetch_bytes_missing``: wire bytes the store should have read for the
  prefixes the window's requests share, less what it read (0: every hit was
  fetched from the store, layer by layer).
- ``objects_missing``: chunk objects the window's requests should have
  committed, less what the store took (0: every complete new chunk was
  written back).
- ``unfinished``: requests started in the window that failed (0).

`compare` is also the control's (``control.py``): the reference in float8
in the program's place.
"""
from __future__ import annotations

import math
import random

import numpy as np
import torch

from ocbench import archs
from ocbench.counts import wire_chunk_bytes


def sample(reqs, seed: int, budget: int) -> list:
    """Requests from ``reqs`` (schedule entries), the longest first and the
    others in an order drawn from ``seed``, as long as the reference's
    tokens stay within ``budget`` (a prefix costs its tokens once)."""
    if not reqs:
        return []
    rest = sorted(reqs, key=lambda r: r.index)
    longest = max(rest, key=lambda r: (r.prompt_len, -r.index))
    rest.remove(longest)
    random.Random(seed).shuffle(rest)
    chosen, cost, seen = [], 0, set()
    for r in [longest] + rest:
        c = r.suffix_len + (r.prefix_len if r.prefix >= 0
                            and r.prefix not in seen else 0)
        if chosen and cost + c > budget:
            continue
        chosen.append(r)
        cost += c
        if r.prefix >= 0:
            seen.add(r.prefix)
    return chosen


def groups(reqs, tokens) -> tuple[list, list]:
    """The reference's prompt groups for ``reqs``: one per shared prefix
    (its tokens and its requests' suffixes), one per unshared prompt; and
    the requests in the order of the suffixes."""
    by_prefix: dict[int, list] = {}
    out, order = [], []
    for r in reqs:
        if r.prefix < 0:
            out.append((tokens.prompt(r)[:0], [tokens.prompt(r)]))
            order.append([r])
        else:
            by_prefix.setdefault(r.prefix, []).append(r)
    for p, rs in sorted(by_prefix.items()):
        out.append((tokens.prefixes[p],
                    [tokens.prompt(r)[r.prefix_len:] for r in rs]))
        order.append(rs)
    return out, [r for rs in order for r in rs]


def compare(params, cfg: dict, tokens, picked, answers) -> dict:
    """``logit_rel_err`` and ``logit_gap`` of ``answers`` (the last-token
    logits [V] of each request in ``picked``, by its index) against the
    fp32 reference; inf where an answer is not finite."""
    if not picked:
        return {"logit_rel_err": math.inf, "logit_gap": math.inf}
    grp, order = groups(picked, tokens)
    model = archs.reference(cfg)
    with torch.no_grad():
        hidden = model.forward(params, cfg, grp)
        last = torch.cat([h for _, sufs in hidden for h in sufs])
        ref = model.Logits(params, cfg)(last).cpu().double().numpy()
    rel, gap = 0.0, 0.0
    for r, want in zip(order, ref):
        got = np.asarray(answers[r.index], dtype=np.float64)
        if not np.isfinite(got).all():
            return {"logit_rel_err": math.inf, "logit_gap": math.inf}
        rel = max(rel, float(np.linalg.norm(got - want)
                             / np.linalg.norm(want)))
        gap = max(gap, float(want.max() - want[int(np.argmax(got))]))
    return {"logit_rel_err": rel, "logit_gap": gap}


def judge(cell, params, tokens, served, before: dict, after: dict,
          seed: int) -> dict:
    """``{name: (value, limit)}`` for the run; correct when every value is
    within its limit."""
    cfg = cell.config
    done = [s for s in served if s.ok]
    picked = sample([s.req for s in done], seed, cell.mix["check_tokens"])
    got = compare(params, cfg, tokens, picked,
                  {s.req.index: s.logits for s in done})
    G = cfg["chunk_tokens"]
    hits = [s for s in done if s.req.prefix >= 0]
    want_read = sum(s.req.prefix_len // G for s in hits) * \
        wire_chunk_bytes(cfg)
    read = after["bytes_read"] - before["bytes_read"]
    want_puts = sum(s.req.prompt_len // G - s.req.prefix_len // G
                    for s in done)
    puts = after["puts"] - before["puts"]
    tried = [s for s in served if s.attempted]
    return {
        "logit_rel_err": (got["logit_rel_err"], cell.limits["logit_rel_err"]),
        "logit_gap": (got["logit_gap"], cell.limits["logit_gap"]),
        "fetch_bytes_missing": (max(0, want_read - read), 0),
        "objects_missing": (max(0, want_puts - puts), 0),
        "unfinished": (len(tried) - len(done), 0),
    }
