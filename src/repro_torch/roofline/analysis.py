"""Roofline terms from the dry run's per-device counts.

Hardware model (NVIDIA H100 SXM 80 GB, per GPU):
    peak bf16 compute  989 TFLOP/s  dense, no sparsity (NVIDIA H100 data
                                    sheet, SXM part, at its 700 W limit)
    HBM bandwidth      3.35 TB/s    (the same data sheet)
    link               50 GB/s      one 400 Gb/s NDR InfiniBand port per GPU
                                    (DGX H100: eight ConnectX-7 ports for
                                    eight GPUs); a 16-way mesh axis spans
                                    two 8-GPU NVLink nodes, so its
                                    collectives run at the network's rate

The counts are PER DEVICE (`CostMode` counts the local ops one rank runs),
so

    compute term    = flops_per_device / peak
    memory term     = bytes_per_device / hbm_bw
    collective term = collective_bytes_per_device / link_bw

MODEL_FLOPS (6·N·D train / 2·N·D forward, N = active params) over counted
FLOPs measures how much of the counted compute is "useful" (catches remat
and redundancy); ``perf_fraction`` is the ideal useful-compute time divided
by the dominant term.

The memory term counts this program's traffic (every eager op's operands
and results), waste included, so its bound grows with the inefficiency it
judges.  `floor_terms` gives the step's floor beside it: the bytes the step
must move (arguments read once, outputs written once) over HBM bandwidth,
and the useful FLOPs over peak.

Port of the reference's ``roofline/analysis.py``: `model_flops` and
`roofline_terms` are the reference's; the constants are the H100's.  There
is no compiled HLO to parse, so `CostMode` stands in for XLA's
``cost_analysis()`` and `collective_bytes_from_log` for
``collective_bytes_from_hlo``, applying the same rule to the functional
collectives seen at dispatch.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry


@dataclasses.dataclass(frozen=True)
class Hardware:
    peak_flops: float = 989e12  # bf16 dense / GPU
    hbm_bw: float = 3.35e12  # B/s
    link_bw: float = 50e9  # B/s per GPU (400 Gb/s NDR InfiniBand)


HW = Hardware()

_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "shard_dim_alltoall": "all-to-all",
                "broadcast": "broadcast", "broadcast_": "broadcast"}
# namespaces of the collectives DTensor issues
_COLLECTIVE_NS = ("_c10d_functional", "c10d", "_dtensor")
# ops that move no bytes: allocations, and the functional collectives'
# bookkeeping (`wait_tensor` returns its input)
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd",
               "lift_fresh", "alias"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_bytes_by_kind(log) -> dict:
    """Per-device collective payload bytes of ``log`` (`CostMode.collectives`:
    (kind, input bytes, result bytes, group size) per op), summed per kind,
    by the reference's rule: all-reduce and all-gather count the result's
    bytes (an all-gather's result is the full buffer a device receives),
    reduce-scatter the result's bytes times the group size (its operand),
    all-to-all its input's bytes, broadcast its result's."""
    out: dict = {}
    for kind, in_bytes, out_bytes, group in log:
        if kind == "reduce-scatter":
            n = out_bytes * group
        elif kind == "all-to-all":
            n = in_bytes
        else:
            n = out_bytes
        out[kind] = out.get(kind, 0.0) + float(n)
    return out


def collective_bytes_from_log(log) -> float:
    """`collective_bytes_by_kind` summed over the kinds."""
    return float(sum(collective_bytes_by_kind(log).values()))


def _rows_in_groups(offs, full: int) -> int:
    """How many of ``full`` rows a grouped product's groups cover: the last
    group offset, or all of them where the offsets cannot be read (meta
    tensors; the MoE dispatch then passes only the rows in groups)."""
    if offs is None or offs.device.type == "meta":
        return full
    return min(int(offs[-1]), full)


def grouped_mm_flop(a, b, offs=None, *args, out_val=None, **kwargs) -> int:
    """FLOPs of ``torch._grouped_mm(a, b, offs)``, which
    `torch.utils.flop_counter` has no formula for: 2 x (rows in groups) x
    K x N for a [M, K] by [G, K, N] product grouped over M, the same with
    the groups over the contracting dim for [K, M] by [M, N] (the weight
    gradient), over N for [G, M, K] by [K, N], and every group's full
    product for [G, M, K] by [G, K, N].  Rows past the last offset are in
    no group and cost nothing, as in the per-expert chain."""
    if a.ndim == 2 and b.ndim == 3:
        return 2 * _rows_in_groups(offs, a.shape[0]) * a.shape[1] \
            * b.shape[2]
    if a.ndim == 2 and b.ndim == 2:
        return 2 * a.shape[0] * _rows_in_groups(offs, a.shape[1]) \
            * b.shape[1]
    if a.ndim == 3 and b.ndim == 2:
        return 2 * a.shape[1] * a.shape[2] \
            * _rows_in_groups(offs, b.shape[1])
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


_FLOPS = {**flop_registry, torch.ops.aten._grouped_mm: grouped_mm_flop}


def _group_size(func, args) -> int:
    import torch.distributed.distributed_c10d as c10d
    name = func.__name__.split(".")[0]
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[2] if name == "reduce_scatter_tensor" else args[1])
    return c10d._resolve_process_group(args[-1]).size()


class CostMode(TorchDispatchMode):
    """Counts what this rank computes, op by op, while it is active.

    A DTensor op is handed back to DTensor (``NotImplemented``), which runs
    it as local ops on this rank's shards, plus the collectives its
    redistributions need; those local ops come back here and are counted:

    * ``flops``: the matrix products' and attentions' FLOPs at the local
      shapes (`torch.utils.flop_counter`'s formulas, and `grouped_mm_flop`
      for the MoE's grouped products; elementwise ops count none);
    * ``bytes_accessed``: every local op's operand and result bytes (eager
      PyTorch fuses nothing, so each op reads and writes memory; views,
      allocations and collectives count none).  This is the port's own
      count, not XLA's, which sees through fusions;
    * ``collectives``: one (kind, input bytes, result bytes, group size)
      per functional collective;
    * ``peak_bytes``: the peak of the bytes held by storages that local ops
      allocated while the mode was active (freed when the storage dies);
      ``peak_by_op``: at that peak, the bytes held per allocating op and
      result shape (``"mm bfloat16 [4096, 14336]"``), which says what the
      peak is made of.

    The ops DTensor runs on fake tensors to propagate shapes are skipped.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.collectives: list[tuple] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_by_op: dict[str, int] = {}
        self._live_by_op: dict[str, int] = {}
        self._held: set[int] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is None:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        packet = func._overloadpacket
        name = packet.__name__
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        if func.namespace in _COLLECTIVE_NS and name in _COLLECTIVES:
            self.collectives.append(
                (_COLLECTIVES[name], sum(map(_nbytes, ins[:1])),
                 sum(map(_nbytes, outs)), _group_size(func, args)))
        elif packet in _FLOPS:
            if func._overloadname == "dtype":
                # mm.dtype / bmm.dtype pass their result dtype third; the
                # formulas take the two operands alone
                args = args[:2]
            self.flops += _FLOPS[packet](*args, **kwargs, out_val=out)
        if func.is_view or name in _NO_TRAFFIC or \
                func.namespace in _COLLECTIVE_NS:
            return
        seen = {id(t): t for t in ins}
        self.bytes_accessed += sum(map(_nbytes, seen.values())) \
            + sum(map(_nbytes, outs))
        for o in outs:
            self._hold(o, f"{name} {str(o.dtype)[6:]} {list(o.shape)}")

    def _hold(self, t: torch.Tensor, label: str = "") -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        self._held.add(key)
        n = st.nbytes()
        self.live_bytes += n
        self._live_by_op[label] = self._live_by_op.get(label, 0) + n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self.peak_by_op = {k: v for k, v in self._live_by_op.items()
                               if v}
        weakref.finalize(st, self._release, key, n, label)

    def _release(self, key: int, n: int, label: str = "") -> None:
        self._held.discard(key)
        self.live_bytes -= n
        self._live_by_op[label] -= n

    def collective_bytes(self) -> float:
        return collective_bytes_from_log(self.collectives)

    def top_of_peak(self, n: int = 12) -> list:
        """The ``n`` largest entries of ``peak_by_op``, largest first."""
        return sorted(self.peak_by_op.items(), key=lambda kv: -kv[1])[:n]


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs for the GLOBAL step (6ND train / 2ND forward,
    N = active params; decode processes global_batch tokens)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * (
            shape.seq_len if cfg.family != "encdec" else
            shape.seq_len + cfg.decoder_train_len)
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * (
            shape.seq_len if cfg.family != "encdec" else
            shape.seq_len + cfg.decoder_train_len)
        return 2.0 * n * tokens
    # decode: one token per sequence; attention reads the cache (memory term)
    return 2.0 * n * shape.global_batch


def floor_terms(cfg, shape, moved_bytes_per_dev: float, n_dev: int,
                hw: Hardware = HW) -> dict:
    """The least time one device could take for its part of the step: the
    larger of ``moved_bytes_per_dev`` (the local arguments read once and
    outputs written once, `launch.dryrun.moved_bytes`) over HBM bandwidth
    and `model_flops` / ``n_dev`` over peak.  Collectives are left out."""
    compute_s = model_flops(cfg, shape) / n_dev / hw.peak_flops
    memory_s = moved_bytes_per_dev / hw.hbm_bw
    return {"floor_compute_s": float(compute_s),
            "floor_memory_s": float(memory_s),
            "step_time_floor_s": float(max(compute_s, memory_s)),
            "floor_bound_by": "operations" if compute_s >= memory_s
            else "bytes"}


def roofline_terms(cfg, shape, flops_per_dev: float, bytes_per_dev: float,
                   collective_bytes_per_dev: float, n_dev: int,
                   hw: Hardware = HW) -> dict:
    compute_s = flops_per_dev / hw.peak_flops
    memory_s = bytes_per_dev / hw.hbm_bw
    collective_s = collective_bytes_per_dev / hw.link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    bottleneck = max(terms, key=terms.get).replace("_s", "")
    mflops = model_flops(cfg, shape)
    useful = mflops / n_dev / hw.peak_flops
    dominant = max(compute_s, memory_s, collective_s)
    return {
        **{k: float(v) for k, v in terms.items()},
        "bottleneck": bottleneck,
        "model_flops_global": float(mflops),
        "useful_flops_ratio": float(mflops / n_dev / max(flops_per_dev, 1.0)),
        "perf_fraction": float(useful / max(dominant, 1e-30)),
        "step_time_bound_s": float(dominant),
    }
