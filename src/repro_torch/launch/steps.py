"""Step builders for the dry run and launchers: per (config, shape, mesh),
produce (step_fn, abstract_args, in_shardings, donate_argnums).

Port of the reference's ``launch/steps.py``.  ``abstract_args`` are trees
of meta tensors (`configs.input_specs`, `Model.param_spec`); the shardings
are `distributed.sharding.Sharding` trees, and `distributed.distribute`
places the args with them.  The step functions take DTensors and run
under ``implicit_replication``, so the plain tensors the model makes
(positions, masks) join the DTensor ops as replicated.  ``donate_argnums``
keeps the reference's values but has no effect: eager PyTorch has no
buffer donation (the AdamW step builds new trees leaf by leaf).
"""
from __future__ import annotations

from repro_torch.configs import input_specs
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed.sharding import (Sharding, batch_pspec,
                                              cache_shardings,
                                              param_shardings,
                                              spec_placements)
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)
from repro_torch.training.train_step import value_and_grad
from repro_torch.training.tree import tree_map


def _batch_shardings(batch: dict, mesh) -> dict:
    return {k: Sharding(mesh, spec_placements(batch_pspec(v.shape, mesh),
                                              mesh))
            for k, v in batch.items()}


def _replicated(fn):
    """``fn`` under DTensor's implicit replication of plain tensors."""
    def run(*args):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            return fn(*args)
    return run


def make_step(cfg, shape_name: str, mesh, *, moe_train_dispatch: str = "ragged",
              remat: bool = True, opt_cfg: AdamWConfig | None = None,
              batch_override: int | None = None,
              seq_override: int | None = None):
    """Build the step for one dry-run cell.

    train_4k   -> train_step(params, opt_state, batch)
    prefill_32k-> prefill_step(params, batch)
    decode_*   -> serve_step(params, cache, token, pos)

    ``batch_override`` / ``seq_override`` cut the inputs (`input_specs`'),
    for steps run on real tensors.
    """
    model = build_model(cfg, "meta")
    kind = SHAPES[shape_name].kind
    specs = input_specs(cfg, shape_name, batch_override, seq_override)
    params_spec = model.param_spec()
    param_sh = param_shardings(params_spec, mesh)

    if kind == "train":
        opt_cfg = opt_cfg or AdamWConfig(
            moment_dtype="bfloat16" if cfg.param_count() > 1e11 else "float32")
        opt_spec = adamw_init(params_spec, opt_cfg)
        opt_sh = {"m": param_sh, "v": param_sh,
                  "step": Sharding(mesh, spec_placements((), mesh))}

        def loss_fn(p, batch, *, remat):
            if cfg.family == "moe":
                return moe_mod.loss(p, cfg, batch, remat=remat,
                                    dispatch=moe_train_dispatch)
            return model.loss(p, batch, remat=remat)

        @_replicated
        def train_step(params, opt_state, batch):
            loss, grads = value_and_grad(model, params, batch, remat=remat,
                                         loss_fn=loss_fn)
            # gradients onto their parameters' placements (the reduction
            # GSPMD inserts for a sharded parameter's gradient)
            grads = tree_map(
                lambda g, p: g.redistribute(p.device_mesh, p.placements),
                grads, params)
            params, opt_state, metrics = adamw_update(grads, opt_state,
                                                      params, opt_cfg)
            metrics["loss"] = loss.full_tensor()
            return params, opt_state, metrics

        args = (params_spec, opt_spec, specs)
        in_sh = (param_sh, opt_sh, _batch_shardings(specs, mesh))
        return train_step, args, in_sh, (0, 1)

    if kind == "prefill":
        @_replicated
        def prefill_step(params, batch):
            return model.prefill(params, batch)
        return (prefill_step, (params_spec, specs),
                (param_sh, _batch_shardings(specs, mesh)), ())

    # decode
    cache_spec = specs["cache"]
    cache_sh = cache_shardings(cache_spec, mesh)

    @_replicated
    def serve_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)

    tok_sh = Sharding(mesh, spec_placements(
        batch_pspec(specs["token"].shape, mesh), mesh))
    pos_sh = Sharding(mesh, spec_placements(
        batch_pspec(specs["pos"].shape, mesh), mesh))
    return (serve_step,
            (params_spec, cache_spec, specs["token"], specs["pos"]),
            (param_sh, cache_sh, tok_sh, pos_sh), (1,))
