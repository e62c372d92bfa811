"""Multi-pod dry run: run every (architecture x input shape) step once on
the production meshes over a fake process group, with NO device memory
(parameters, optimizer state, caches and inputs are meta tensors).

Per cell this script records:
  * ``memory_analysis`` — per-device bytes: the arguments' local shards
    (``argument_size_in_bytes``), the outputs' (``output_size_in_bytes``),
    and the peak of the bytes the step allocated (``temp_size_in_bytes``,
    outputs included) and what it is made of (``peak_by_op``: the largest
    holdings at the peak, by allocating op and shape) — proves the cell fits
    the card's HBM;
  * ``flops`` / ``bytes_accessed`` — per-device counts of the local ops
    (`roofline.CostMode`) of the busiest rank (``counted_rank``; see
    `count_busiest`);
  * ``collective_bytes`` — from the functional collectives DTensor issues
    (`roofline.collective_bytes_from_log`), and per kind
    (``collective_bytes_by_kind``: all-gather, all-reduce, ...);
  * the roofline terms (compute / memory / collective) for the H100's
    constants (`roofline.HW`), and beside them the step's floor
    (`roofline.floor_terms`: the bytes it must move, ``moved_bytes``, and
    its useful FLOPs), which the eager traffic of the memory term does not
    bound from below.

Port of the reference's ``launch/dryrun.py``, redone for eager PyTorch.
``main()`` (not import) starts a fake process group of as many ranks as the
mesh has devices (``FakeStore``, backend "fake": collectives return at
once and move nothing), builds the mesh with device type "cuda", places
meta trees on it with `distributed.distribute`, and runs the step once
under `CostMode`.  The mode sees the local ops the group's rank runs, so
its counts are per device by construction: a replicated op is counted in
full, a sharded one at its local shape.  Ranks may differ (O2's query
rows at a higher 'model' coordinate attend to more keys), so the step is
counted on the first and the last rank and the busier is reported.  The port's layer stacks are Python loops,
so that one pass already gives per-step counts: the reference's
``scan_util.FULL_UNROLL`` has no counterpart.  `two_point_counts` stays (two
reduced-depth passes, extrapolated), because it is cheaper.  Bytes accessed
are the port's own count: every eager op's operand and result bytes, since
eager PyTorch fuses nothing; XLA's count sees through fusions.

Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json;
reruns skip completed cells unless --force.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-1-8b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both
"""
import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import SHAPES, get_config, get_smoke_config, list_archs
from repro_torch.configs.shapes import is_applicable
from repro_torch.distributed.sharding import distribute
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.steps import make_step
from repro_torch.roofline.analysis import (CostMode,
                                           collective_bytes_by_kind,
                                           floor_terms, roofline_terms)
from repro_torch.training.tree import tree_leaves

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
# mesh kinds: the two production meshes, the tests' debug mesh, one device
MESH_SIZES = {"pod": 256, "multipod": 512, "debug": 8, "one": 1}


def _mesh(kind: str, device_type: str = "cuda", last: bool = False):
    """The mesh of ``kind`` over a fake process group of its size (the
    group, always seen from rank 0, is started, or restarted at another
    size, here).  ``last``: the same mesh with its ranks in reverse order,
    so that this process stands at the last coordinate on every axis, where
    global rank n - 1 stands in the mesh's own order (a distinct mesh, so
    DTensor's caches keyed by the mesh do not mix the two).  Its device
    type is "cuda" by default, as on the cards, so DTensor redistributes
    as it would there (all-to-all; a "cpu" mesh, as gloo's, falls back to
    all-gather and chunk); the tensors stay on meta."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = MESH_SIZES[kind]
    if dist.is_initialized() and dist.get_world_size() != n:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    if kind == "debug":
        mesh = make_debug_mesh(2, 4, device_type=device_type)
    elif kind == "one":
        mesh = make_debug_mesh(1, 1, device_type=device_type)
    else:
        mesh = make_production_mesh(multi_pod=(kind == "multipod"),
                                    device_type=device_type)
    if not last:
        return mesh
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.arange(n).flip(0).reshape(
        mesh.shape), mesh_dim_names=mesh.mesh_dim_names)


def cell_path(arch: str, shape: str, mesh_kind: str,
              variant: str = "base", smoke: bool = False) -> str:
    suffix = "" if variant == "base" else f"__{variant}"
    if smoke:
        suffix += "__smoke"
    return os.path.join(OUT_DIR, f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def apply_variant(cfg, shape_name: str, variant: str):
    """Optimisation bundles applied on top of a baseline config."""
    if variant == "base":
        return cfg
    if variant == "opt":
        kind = SHAPES[shape_name].kind
        changes = dict(attn_impl="blocked", attn_block_k=512,
                       decode_impl="blocked", decode_blocks=16)
        if kind == "prefill":
            changes["attn_seq_shard"] = True  # O2: Sq over 'model'
        return dataclasses.replace(cfg, **changes)
    raise ValueError(variant)


def _local_leaves(trees):
    for t in (leaf for tree in trees for leaf in tree_leaves(tree)):
        if isinstance(t, torch.Tensor):
            yield t.to_local() if isinstance(t, DTensor) else t


def _local_bytes(trees) -> int:
    """Bytes of the local shards of a list of trees' tensor leaves."""
    return sum(t.numel() * t.element_size() for t in _local_leaves(trees))


def local_storages(trees) -> dict:
    """{storage: bytes} of the local shards of a list of trees' tensor
    leaves (a storage once, at its largest leaf)."""
    out = {}
    for t in _local_leaves(trees):
        key = t.untyped_storage()._cdata
        out[key] = max(out.get(key, 0), t.numel() * t.element_size())
    return out


def moved_bytes(args: dict, outs: dict) -> int:
    """The bytes a step must move, from `local_storages` of its arguments
    (taken before the step) and of its outputs: every argument read once,
    every output written once; an output that is an argument updated in
    place (the decode cache) counts once, as read."""
    return sum(args.values()) + sum(n for k, n in outs.items()
                                    if k not in args)


def realize(specs: dict, cfg, generator: torch.Generator, device,
            seq_len: int) -> dict:
    """Real tensors for `input_specs`' meta specs, to run a step on:
    tokens and labels uniform in [0, vocab), embeddings N(0, 1), a decode
    cache zero and every position ``seq_len - 1`` (the cache's last slot)."""
    from repro_torch.training.tree import tree_map
    out = {}
    for k, t in specs.items():
        if k == "cache":
            out[k] = tree_map(lambda c: torch.zeros(
                c.shape, dtype=c.dtype, device=device), t)
        elif k == "pos":
            out[k] = torch.full(t.shape, seq_len - 1, dtype=t.dtype,
                                device=device)
        elif t.dtype.is_floating_point:
            out[k] = torch.randn(t.shape, generator=generator).to(
                device=device, dtype=t.dtype)
        else:
            out[k] = torch.randint(0, cfg.vocab_size, t.shape,
                                   generator=generator).to(
                device=device, dtype=t.dtype)
    return out


def count_step(cfg, shape_name: str, mesh, args=None, **cut) -> dict:
    """Place the step's args on ``mesh`` and run it once under `CostMode`:
    per-device counts and memory.  ``args``: real tensors in place of the
    step's meta specs (the same trees); ``cut``: `make_step`'s
    ``batch_override`` / ``seq_override``."""
    step_fn, specs, in_sh, _ = make_step(cfg, shape_name, mesh, **cut)
    placed = [distribute(a, s)
              for a, s in zip(specs if args is None else args, in_sh)]
    held = local_storages(placed)
    mode = CostMode()
    t0 = time.time()
    with mode:
        out = step_fn(*placed)
    return {"flops": mode.flops, "bytes_accessed": mode.bytes_accessed,
            "collective_bytes": mode.collective_bytes(),
            "collective_bytes_by_kind": collective_bytes_by_kind(
                mode.collectives),
            "collectives": len(mode.collectives), "run_s": time.time() - t0,
            "moved_bytes": moved_bytes(held, local_storages(out)),
            "memory_analysis": {
                "argument_size_in_bytes": _local_bytes(placed),
                "output_size_in_bytes": _local_bytes(out),
                "temp_size_in_bytes": int(mode.peak_bytes),
                "peak_by_op": dict(mode.top_of_peak())}}


def count_busiest(cfg, shape_name: str, mesh_kind: str,
                  device_type: str = "cuda", **cut) -> dict:
    """`count_step` on the first and the last rank of the ``mesh_kind``
    mesh (`_mesh`'s ``last``; ``cut`` as `count_step`'s); the counts of the
    one with the larger step bound, with ``counted_rank`` (0 or n - 1) and
    both ranks' counts (``per_rank``).

    Every rank runs the same local shapes except where a causal sequence is
    sharded: under O2 the query rows at 'model' coordinate m attend to the
    keys up to their own positions, so the work grows with m (and an
    uneven shard would leave the last rank the least).  The first rank
    (coordinate 0 on every axis) and the last (the largest on every axis)
    are the two ends; the step waits for the busier (the larger bound; at
    equal bounds, more FLOPs, then more bytes)."""
    n = MESH_SIZES[mesh_kind]
    per_rank = {}
    for rank in sorted({0, n - 1}):
        c = count_step(cfg, shape_name,
                       _mesh(mesh_kind, device_type, last=rank > 0), **cut)
        c["bound_s"] = roofline_terms(
            cfg, SHAPES[shape_name], c["flops"], c["bytes_accessed"],
            c["collective_bytes"], n)["step_time_bound_s"]
        per_rank[rank] = c
    rank = max(per_rank, key=lambda r: tuple(per_rank[r][k] for k in (
        "bound_s", "flops", "bytes_accessed")))
    return {**per_rank[rank], "counted_rank": rank, "per_rank": {
        str(r): {"flops": c["flops"], "bytes_accessed": c["bytes_accessed"],
                 "collective_bytes": c["collective_bytes"],
                 "bound_s": c["bound_s"], "temp_size_in_bytes":
                     c["memory_analysis"]["temp_size_in_bytes"]}
        for r, c in per_rank.items()}}


def two_point_counts(cfg, shape_name: str, mesh) -> tuple[float, float, float, float]:
    """Per-step counts by linear extrapolation over the layer stack.

    Runs two reduced-depth variants (L1 < L2 << L) and extrapolates
    counts(L) = f(L1) + slope*(L - L1).  Exact for homogeneous stacks
    (every assigned arch is layerwise homogeneous up to its structural
    period).
    """
    period = 1
    if cfg.family == "hybrid":
        period = cfg.shared_attn_every
    elif cfg.family == "moe":
        period = cfg.moe_every
    L1, L2 = 2 * period, 4 * period
    t0 = time.time()
    results = []
    for L in (L1, L2):
        changes = {"num_layers": L}
        if cfg.family == "encdec":
            changes["encoder_layers"] = L
        c = count_step(dataclasses.replace(cfg, **changes), shape_name, mesh)
        results.append((c["flops"], c["bytes_accessed"],
                        c["collective_bytes"]))
    f1, f2 = results
    L = cfg.num_layers
    out = tuple(a + (b - a) / (L2 - L1) * (L - L1) for a, b in zip(f1, f2))
    return (*out, time.time() - t0)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             force: bool = False, variant: str = "base",
             counts: str = "full", smoke: bool = False) -> dict:
    out_file = cell_path(arch, shape_name, mesh_kind, variant, smoke)
    if os.path.exists(out_file) and not force:
        with open(out_file) as f:
            return json.load(f)

    base = get_smoke_config(arch) if smoke else get_config(arch)
    cfg = apply_variant(base, shape_name, variant)
    ok, why = is_applicable(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "variant": variant, "smoke": smoke, "status": "skipped",
           "reason": why}
    if not ok:
        _write(out_file, rec)
        return rec

    try:
        c = count_busiest(cfg, shape_name, mesh_kind)
        n_dev = MESH_SIZES[mesh_kind]
        flops, bytes_accessed, coll = (c["flops"], c["bytes_accessed"],
                                       c["collective_bytes"])
        rec.update(status="ok", num_devices=n_dev,
                   run_s=round(c["run_s"], 2),
                   counted_rank=c["counted_rank"], per_rank=c["per_rank"],
                   memory_analysis=c["memory_analysis"],
                   moved_bytes=c["moved_bytes"],
                   collective_ops=c["collectives"],
                   collective_bytes_by_kind=c["collective_bytes_by_kind"],
                   counts_method="full_pass")
        if counts == "two_point":
            flops, bytes_accessed, coll, dt = two_point_counts(
                cfg, shape_name, _mesh(mesh_kind, last=c["counted_rank"] > 0))
            rec.update(counts_method="two_point", two_point_s=round(dt, 2),
                       flops_full_pass=c["flops"])
        rec.update(
            flops=flops,
            bytes_accessed=bytes_accessed,
            collective_bytes=coll,
            roofline=roofline_terms(cfg, SHAPES[shape_name], flops,
                                    bytes_accessed, coll, n_dev),
            floor=floor_terms(cfg, SHAPES[shape_name], c["moved_bytes"],
                              n_dev),
        )
    except Exception as e:  # a failure here is a bug in the system
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    _write(out_file, rec)
    return rec


def _write(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both", "debug", "one"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="base", choices=["base", "opt"])
    ap.add_argument("--counts", default="full",
                    choices=["full", "two_point"])
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (tests)")
    args = ap.parse_args()

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                rec = run_cell(arch, shape, mk, force=args.force,
                               variant=args.variant, counts=args.counts,
                               smoke=args.smoke)
                line = (f"{arch:28s} {shape:12s} {mk:9s} {args.variant:5s} "
                        f"{rec['status']:8s}")
                if rec["status"] == "ok":
                    r, fl = rec["roofline"], rec["floor"]
                    mem = rec["memory_analysis"]
                    line += (f" rank={rec['counted_rank']}"
                             f" run={rec['run_s']:7.1f}s"
                             f" args={mem['argument_size_in_bytes']:.3e}B"
                             f" temp={mem['temp_size_in_bytes']:.3e}B"
                             f" flops={rec['flops']:.3e}"
                             f" bytes={rec['bytes_accessed']:.3e}"
                             f" comm={rec['collective_bytes']:.3e}B"
                             f" compute={r['compute_s']:.4e}s"
                             f" memory={r['memory_s']:.4e}s"
                             f" collective={r['collective_s']:.4e}s"
                             f" bottleneck={r['bottleneck']}"
                             f" moved={rec['moved_bytes']:.3e}B"
                             f" floor={fl['step_time_floor_s']:.4e}s")
                elif rec["status"] == "error":
                    line += " " + rec["error"][:120]
                    failures += 1
                print(line, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
