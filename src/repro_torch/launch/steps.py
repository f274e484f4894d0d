"""Step builders for training, prefill and serving (port of
``repro.launch.steps``), shared by the entry points and by anything that wants
a step's abstract arguments without allocating them.

Each builder returns ``(step, abstract, placements, out_placements)``, as
the reference returns ``(step_fn, abstract_args, in_shardings,
out_shardings)``:

* ``step`` is the port's own step (``make_full_step``, ``make_stage_step``,
  ``models.model.prefill`` / ``decode_step``, ``make_fl_round_step``) on
  ``resolve_config(cfg, SHAPES[shape_name])``, on ``device`` (the card by
  default; ``device="cpu"`` asks for the CPU, and with no card and no
  ``"cpu"`` the builder raises): it moves any argument tensor that lies
  elsewhere onto it (a no-op for those already there);
* ``abstract`` holds ``meta`` tensors of its arguments' shapes and dtypes
  (nothing allocated);
* ``placements`` are ``launch.sharding.Placement`` trees fitted to
  ``mesh`` (a ``launch.mesh.HostMesh`` or anything with ``axis_names``
  and a ``shape`` mapping): a param leaf's dim over "model"
  (``tree_placements``), a batch leaf's leading axis over the data axes
  (``batch_spec``, in ``cohort_axis``), ``Placement(None)`` replicated.

``REPRO_SHARDING_POLICY`` (``tp`` by default, or ``fsdp``) picks the batch
axes, as in the reference.  The optimizer state's abstract m and v are
float32, as ``adamw`` and ``sgd`` keep them (the reference's abstract
gives them the params' dtype).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from repro_torch import optim
from repro_torch.common import paramdef as PD
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_map
from repro_torch.configs.shapes import (SHAPES, decode_inputs, label_specs,
                                        resolve_config, token_inputs)
from repro_torch.core.curriculum import CurriculumHP
from repro_torch.core.progressive import (make_full_step, make_stage_step,
                                          make_transformer_adapter)
from repro_torch.launch.sharding import (Placement, batch_spec, fit_spec,
                                         tree_placements)
from repro_torch.models import model as tx
from repro_torch.models.config import ModelConfig


def _opt_state_defs(optimizer_name: str, param_defs):
    """ParamDef tree describing the optimizer state (float32 slots, an
    int32 counter)."""
    scalar = PD.ParamDef((), torch.int32, (), init="zeros")
    slots = tree_map(lambda d: dataclasses.replace(d, dtype=torch.float32),
                     param_defs)
    if optimizer_name == "sgd":
        return {"mu": slots, "step": scalar}
    return {"m": slots, "v": slots, "step": scalar}


def _defs_to_abstract(def_tree):
    return PD.shape_tree(def_tree)


def make_optimizer(name: str, lr: float = 1e-3):
    if name == "sgd":
        return optim.sgd(lr, momentum=0.9, weight_decay=5e-4)
    return optim.adamw(lr)


def _mesh_batch_shards(mesh) -> int:
    g = 1
    for ax in ("pod", "data"):
        if ax in mesh.shape:
            g *= mesh.shape[ax]
    return g


def align_moe_dispatch(cfg: ModelConfig, mesh) -> ModelConfig:
    """MoE dispatch groups aligned with the mesh's batch shards, so that
    the routing's sort and gathers stay shard-local (``moe.moe_apply``);
    ``cfg`` as it is without MoE.  ``REPRO_MOE_GROUPS`` overrides the
    count (1: one global dispatch), as in the reference."""
    if cfg.moe is None:
        return cfg
    g = int(os.environ.get("REPRO_MOE_GROUPS", "0")) or \
        _mesh_batch_shards(mesh)
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=g))


def _on(device: DeviceLike, step):
    """``step`` with its tensor arguments on ``device`` (resolved now)."""
    dev = resolve_device(device)

    def on_device(*args):
        return step(*tree_map(
            lambda a: a.to(dev) if torch.is_tensor(a) else a, args))

    on_device.device = dev
    on_device.step = step           # the step itself (the dry-run's)
    return on_device


def _policy() -> str:
    return os.environ.get("REPRO_SHARDING_POLICY", "tp")


def replicated(mesh) -> Placement:
    return Placement(None)


def batch_placements(abstract_tree, mesh, policy: str = "tp"):
    """Per leaf of a batch: its leading axis over the data axes that
    ``batch_spec`` gives (``cohort_axis``; ``None`` where none divides)."""
    def fit(t):
        spec = batch_spec(tuple(t.shape), mesh, policy)
        return Placement(None, spec[0] if spec else None)
    return tree_map(fit, abstract_tree)


def _train_batch(cfg, shape):
    B, S = shape.global_batch, shape.seq_len
    return {"inputs": token_inputs(cfg, B, S),
            "labels": label_specs(cfg, B, S)}


# --------------------------------------------------------------------------- #
# full-model train step (vanilla FL / E2E baseline)
# --------------------------------------------------------------------------- #
def build_full_train(cfg: ModelConfig, shape_name: str, mesh,
                     optimizer_name: str = "adamw",
                     device: DeviceLike = None, wrap_optimizer=None):
    """``wrap_optimizer(optimizer)`` gives the optimizer the step runs in
    place of ``make_optimizer(optimizer_name)``'s (the dry-run's reduces
    the gradients over the data axes first); the abstract state is
    ``optimizer_name``'s."""
    shape = SHAPES[shape_name]
    cfg = align_moe_dispatch(resolve_config(cfg, shape), mesh)
    adapter = make_transformer_adapter(cfg, num_stages=4)
    opt = make_optimizer(optimizer_name)
    step = _on(device, make_full_step(
        adapter, opt if wrap_optimizer is None else wrap_optimizer(opt)))

    neulite_defs = adapter.defs
    opt_defs = _opt_state_defs(optimizer_name, neulite_defs)
    batch_abs = _train_batch(cfg, shape)
    abstract = (_defs_to_abstract(opt_defs), _defs_to_abstract(neulite_defs),
                batch_abs)
    placements = (tree_placements(opt_defs, mesh),
                  tree_placements(neulite_defs, mesh),
                  batch_placements(batch_abs, mesh, _policy()))
    out_placements = (placements[0], placements[1], replicated(mesh))
    return step, abstract, placements, out_placements


# --------------------------------------------------------------------------- #
# NeuLite progressive stage step (the paper's train step)
# --------------------------------------------------------------------------- #
def build_neulite_train(cfg: ModelConfig, shape_name: str, mesh,
                        optimizer_name: str = "adamw", num_stages: int = 4,
                        stage: Optional[int] = None,
                        curriculum: bool = True,
                        use_hsic_kernel: bool = False,
                        device: DeviceLike = None, wrap_optimizer=None):
    """``use_hsic_kernel`` routes the curriculum's nHSIC through K1-K3
    (the reference's default, its plain nHSIC, is off); ``wrap_optimizer``
    as in ``build_full_train``."""
    shape = SHAPES[shape_name]
    cfg = align_moe_dispatch(resolve_config(cfg, shape), mesh)
    adapter = make_transformer_adapter(cfg, num_stages=num_stages)
    # the plan may clamp num_stages to the period count (small configs)
    t = adapter.plan.num_stages // 2 if stage is None else stage
    hp = CurriculumHP(enabled=curriculum, use_hsic_kernel=use_hsic_kernel)
    opt = make_optimizer(optimizer_name)
    step = _on(device, make_stage_step(
        adapter, opt if wrap_optimizer is None else wrap_optimizer(opt), hp,
        t))

    frozen_defs, trainable_defs = adapter.split_stage(adapter.defs, t)
    opt_defs = _opt_state_defs(optimizer_name, trainable_defs)
    batch_abs = _train_batch(cfg, shape)
    abstract = (_defs_to_abstract(opt_defs),
                _defs_to_abstract(trainable_defs),
                _defs_to_abstract(frozen_defs),
                batch_abs,
                _defs_to_abstract(trainable_defs))      # global_ref
    placements = (tree_placements(opt_defs, mesh),
                  tree_placements(trainable_defs, mesh),
                  tree_placements(frozen_defs, mesh),
                  batch_placements(batch_abs, mesh, _policy()),
                  tree_placements(trainable_defs, mesh))
    out_placements = (placements[0], placements[1], replicated(mesh))
    return step, abstract, placements, out_placements


# --------------------------------------------------------------------------- #
# prefill step
# --------------------------------------------------------------------------- #
def build_prefill(cfg: ModelConfig, shape_name: str, mesh,
                  device: DeviceLike = None):
    shape = SHAPES[shape_name]
    cfg = align_moe_dispatch(resolve_config(cfg, shape), mesh)

    @torch.no_grad()
    def prefill(params, inputs):
        return tx.prefill(params, cfg, inputs)

    prefill_step = _on(device, prefill)

    model_defs = tx.model_defs(cfg)
    B, S = shape.global_batch, shape.seq_len
    inputs_abs = token_inputs(cfg, B, S)
    abstract = (_defs_to_abstract(model_defs), inputs_abs)
    placements = (tree_placements(model_defs, mesh),
                  batch_placements(inputs_abs, mesh))
    out_placements = (replicated(mesh),
                      tree_placements(tx.cache_defs(cfg, B, S), mesh))
    return prefill_step, abstract, placements, out_placements


# --------------------------------------------------------------------------- #
# serve (decode) step
# --------------------------------------------------------------------------- #
def build_serve(cfg: ModelConfig, shape_name: str, mesh,
                device: DeviceLike = None):
    """The decode step, which writes the caches in place; its ``pos`` is
    a Python int (the abstract's 0-d int32 stands for it)."""
    shape = SHAPES[shape_name]
    cfg = align_moe_dispatch(resolve_config(cfg, shape), mesh)

    @torch.no_grad()
    def decode(params, inputs, caches, pos):
        return tx.decode_step(params, cfg, inputs, caches, int(pos))

    serve_step = _on(device, decode)

    model_defs = tx.model_defs(cfg)
    B, S = shape.global_batch, shape.seq_len
    cache_defs_tree = tx.cache_defs(cfg, B, S)
    inputs_abs = decode_inputs(cfg, B)
    abstract = (_defs_to_abstract(model_defs), inputs_abs,
                _defs_to_abstract(cache_defs_tree),
                torch.empty((), dtype=torch.int32, device="meta"))
    placements = (tree_placements(model_defs, mesh),
                  batch_placements(inputs_abs, mesh),
                  tree_placements(cache_defs_tree, mesh),
                  replicated(mesh))
    out_placements = (replicated(mesh), placements[2])
    return serve_step, abstract, placements, out_placements


# --------------------------------------------------------------------------- #
# full FL round (paper Alg. 1 round as one program)
# --------------------------------------------------------------------------- #
def build_fl_round(cfg: ModelConfig, shape_name: str, mesh,
                   optimizer_name: str = "sgd", num_stages: int = 4,
                   stage: Optional[int] = None, local_steps: int = 4,
                   device: DeviceLike = None, aggregate=None,
                   use_hsic_kernel: bool = False):
    """Cohorts = batch shards; E local steps with no cross-cohort traffic;
    the sample-weighted FedAvg of the trainable subtree ends the round
    (``aggregate``, ``federated.runtime.eq1_aggregate`` by default: the
    dry-run's reduces over the mesh)."""
    from repro_torch.federated.runtime import (cohort_batches_specs,
                                               make_fl_round_step)
    shape = SHAPES[shape_name]
    cfg = align_moe_dispatch(resolve_config(cfg, shape), mesh)
    adapter = make_transformer_adapter(cfg, num_stages=num_stages)
    # the plan may clamp num_stages to the period count (small configs)
    t = adapter.plan.num_stages // 2 if stage is None else stage
    round_fn = _on(device, make_fl_round_step(
        adapter, make_optimizer(optimizer_name),
        CurriculumHP(use_hsic_kernel=use_hsic_kernel), t, aggregate))

    C = _mesh_batch_shards(mesh)
    B, S = shape.global_batch, shape.seq_len
    per_cohort = max(1, B // C)
    frozen_defs, trainable_defs = adapter.split_stage(adapter.defs, t)
    batches_abs = cohort_batches_specs(cfg, C, local_steps, per_cohort, S)

    def cohort_placement(t_):
        spec = fit_spec(tuple(t_.shape), (("pod", "data"),), mesh)
        return Placement(None, spec[0] if spec else None)

    abstract = (_defs_to_abstract(trainable_defs),
                _defs_to_abstract(frozen_defs),
                batches_abs,
                torch.empty((C,), dtype=torch.float32, device="meta"))
    placements = (tree_placements(trainable_defs, mesh),
                  tree_placements(frozen_defs, mesh),
                  tree_map(cohort_placement, batches_abs),
                  replicated(mesh))
    out_placements = (placements[0], replicated(mesh))
    return round_fn, abstract, placements, out_placements


BUILDERS = {
    "train": build_full_train,
    "neulite": build_neulite_train,
    "prefill": build_prefill,
    "decode": build_serve,
    "flround": build_fl_round,
}


def builder_for(shape_name: str, paper_mode: bool = False) -> str:
    kind = SHAPES[shape_name].kind
    if kind == "train":
        return "neulite" if paper_mode else "train"
    return kind
