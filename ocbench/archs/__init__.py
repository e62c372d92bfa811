"""What the yardstick knows of a model architecture, one module each,
found by the Hugging Face class that a configuration file names first in
``architectures``.

An architecture module ``archs/<module>.py`` lists the classes it takes in
``ARCHITECTURES`` and gives, from a configuration file's dict:

- ``program_config(cfg)``: the program's ``ModelConfig``, importing the
  program inside the function;
- ``weight_shapes(cfg)``: the tree of (shape, dtype, mean, std) the weights
  are drawn from, one leaf a ``normal_`` call, in draw order;
- ``active_nonembed_params(cfg)`` and ``prefill_flops(cfg, prefix_len,
  computed)``;
- ``kv_tensors(cfg)``: the number of layers that hold KV, and the width a
  token has in each tensor such a layer stores;
- ``REFERENCE``: the module under ``reference/`` that gives ``forward(params,
  cfg, groups, *, fp8=False)`` and ``Logits(params, cfg, fp8=False)``.

It imports nothing of the program at module level.
"""
from __future__ import annotations

import functools
import importlib
import importlib.util
from pathlib import Path
from types import ModuleType

DIR = Path(__file__).resolve().parent  # where the architecture modules are


@functools.cache
def modules(directory: Path) -> dict[str, list[ModuleType]]:
    """Every class that a module in ``directory`` lists, with the modules
    that list it."""
    out: dict[str, list[ModuleType]] = {}
    for path in sorted(directory.glob("*.py")):
        if path.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            "ocbench_arch_" + path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for cls in mod.ARCHITECTURES:
            out.setdefault(cls, []).append(mod)
    return out


def of(cfg: dict) -> ModuleType:
    """The architecture module of configuration ``cfg``."""
    known = modules(DIR)
    names = cfg.get("architectures")
    if not names:
        raise ValueError(f"configuration {cfg.get('name')!r} names no "
                         f"'architectures'; known classes: {sorted(known)}")
    claims = known.get(names[0], [])
    if len(claims) != 1:
        which = ", ".join(sorted(Path(m.__file__).name for m in claims))
        raise ValueError(f"{names[0]!r} is listed by {len(claims)} modules "
                         f"in {DIR} ({which or 'none'}), not by exactly one; "
                         f"known classes: {sorted(known)}")
    return claims[0]


def reference(cfg: dict) -> ModuleType:
    """The plain reference of ``cfg``'s architecture."""
    return importlib.import_module(f"ocbench.reference.{of(cfg).REFERENCE}")
