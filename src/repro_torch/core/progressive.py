"""Progressive-training engine: the transformer and CNN adapters, the
stage train step and the full-model step (port of
``repro.core.progressive``).

An ``Adapter`` binds a model family (stacked transformer periods or a CNN
unit list) to the NeuLite engine.  It owns the
combined ParamDef tree (model, output-module surrogates, nHSIC projectors),
``split_stage(params, t) -> (frozen, trainable)``, ``merge_stage(params,
trainable, t)`` and ``stage_apply(frozen, trainable, inputs)``.  Params are
dict trees of tensors with the reference's keys and nesting.

``make_stage_step`` takes gradients and optimizer state over the trainable
subtree only; the frozen prefix is a plain forward input run under
``torch.no_grad``, so it keeps no activations, gradients or optimizer state.
That is the paper's memory claim.  ``make_full_step`` is what it is held
against: end-to-end training of the whole model (FedAvg's step).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.common import paramdef as PD
from repro_torch.common.device import DeviceLike
from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.core import curriculum as cur
from repro_torch.core.blocks import BlockPlan, make_plan
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import model as tx
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import apply_updates


@dataclasses.dataclass
class Adapter:
    kind: str                       # "transformer" | "cnn"
    cfg: Any
    plan: BlockPlan
    defs: dict
    num_classes: int
    split_stage: Callable[[Any, int], tuple]
    merge_stage: Callable[[Any, Any, int], Any]
    stage_apply: Callable[[Any, Any, dict], tuple]
    full_loss: Callable[[Any, dict], torch.Tensor]
    forward_eval: Callable[[Any, dict], torch.Tensor]

    def init_params(self, seed: int, device: DeviceLike = None):
        return PD.init_params(seed, self.defs, device)


# =========================================================================== #
# transformer adapter (stacked periods)
# =========================================================================== #
def neulite_defs(cfg: ModelConfig, plan: BlockPlan) -> dict:
    return {"model": tx.model_defs(cfg),
            "surrogates": tx.surrogate_defs(cfg, plan.num_stages),
            "projector": tx.projector_defs(cfg)}


def _slice_tree(tree, s: int, e: int):
    """Rows [s, e) of the leading axis of every leaf (views of tensors;
    sliced ParamDefs).  An empty range gives empty leaves."""
    return tree_map(lambda x: x[s:e], tree)


def _setslice_tree(full, part, s: int):
    """``full`` with rows [s, s + n) of every leaf replaced by ``part``'s
    n rows, as new tensors: the views that ``split_stage`` handed out are
    not written."""
    def put(f, p):
        n = p.shape[0]
        if n == 0:
            return f
        return torch.cat([f[:s], p.to(f.dtype), f[s + n:]])

    return tree_map(put, full, part)


def make_transformer_adapter(cfg: ModelConfig, num_stages: int,
                             boundary_units: int = 1) -> Adapter:
    plan = make_plan(cfg.num_periods, num_stages, boundary_units)
    defs = neulite_defs(cfg, plan)
    T = plan.num_stages

    def split_stage(params, t):
        (f0, f1), (b0, b1), (a0, a1) = plan.stage_ranges(t)
        layers = params["model"]["layers"]
        frozen = {}
        trainable = {}
        (trainable if t == 0 else frozen)["embed"] = params["model"]["embed"]
        frozen["prefix"] = _slice_tree(layers, f0, f1)
        trainable["boundary"] = _slice_tree(layers, b0, b1)
        trainable["active"] = _slice_tree(layers, a0, a1)
        trainable["surrogates"] = (
            _slice_tree(params["surrogates"], t, T - 1) if t < T - 1
            else None)
        trainable["projector"] = params["projector"]
        trainable["final_norm"] = params["model"]["final_norm"]
        trainable["head"] = params["model"]["head"]
        return frozen, trainable

    def merge_stage(params, trainable, t):
        (_, _), (b0, _b1), (a0, _a1) = plan.stage_ranges(t)
        params = dict(params)
        model = dict(params["model"])
        layers = _setslice_tree(model["layers"], trainable["boundary"], b0)
        model["layers"] = _setslice_tree(layers, trainable["active"], a0)
        if trainable.get("embed") is not None:
            model["embed"] = trainable["embed"]
        model["final_norm"] = trainable["final_norm"]
        model["head"] = trainable["head"]
        params["model"] = model
        if trainable.get("surrogates") is not None:
            params["surrogates"] = _setslice_tree(
                params["surrogates"], trainable["surrogates"], t)
        params["projector"] = trainable["projector"]
        return params

    def stage_apply(frozen, trainable, inputs):
        return tx.stage_apply(frozen, trainable, cfg, inputs)

    def full_loss(params, batch):
        return tx.loss_fn(params["model"], cfg, batch)

    def forward_eval(params, inputs):
        return tx.forward(params["model"], cfg, inputs)

    return Adapter(kind="transformer", cfg=cfg, plan=plan, defs=defs,
                   num_classes=cfg.vocab_size, split_stage=split_stage,
                   merge_stage=merge_stage, stage_apply=stage_apply,
                   full_loss=full_loss, forward_eval=forward_eval)


# =========================================================================== #
# CNN adapter (unit lists)
# =========================================================================== #
def make_cnn_adapter(ccfg: cnn_mod.CNNConfig, num_stages: int,
                     boundary_units: int = 1) -> Adapter:
    metas = cnn_mod.unit_meta(ccfg)
    plan = make_plan(len(metas), num_stages, boundary_units)
    base = cnn_mod.cnn_defs(ccfg)
    sur = cnn_mod.cnn_surrogate_defs(ccfg, list(plan.bounds))
    # per-stage projector input dim = active block's output channels
    proj = [cnn_mod.cnn_projector_defs(ccfg, metas[e - 1][1]["cout"])
            for s, e in plan.bounds]
    defs = {"model": base, "surrogates": sur, "projector": proj}

    def split_stage(params, t):
        (f0, f1), (b0, b1), (a0, a1) = plan.stage_ranges(t)
        units = params["model"]["units"]
        frozen = {"units": units[f0:f1]}
        trainable = {
            "boundary_units": units[b0:b1],
            "units": units[a0:a1],
            "surrogates": params["surrogates"][t:] if t < plan.num_stages - 1
            else None,
            "projector": params["projector"][t],
            "head": params["model"]["head"],
        }
        return frozen, trainable

    def merge_stage(params, trainable, t):
        (_, _), (b0, b1), (a0, a1) = plan.stage_ranges(t)
        params = dict(params)
        model = dict(params["model"])
        units = list(model["units"])
        units[b0:b1] = trainable["boundary_units"]
        units[a0:a1] = trainable["units"]
        model["units"] = units
        model["head"] = trainable["head"]
        params["model"] = model
        if trainable.get("surrogates") is not None:
            sur = list(params["surrogates"])
            sur[t:] = trainable["surrogates"]
            params["surrogates"] = sur
        proj = list(params["projector"])
        proj[t] = trainable["projector"]
        params["projector"] = proj
        return params

    def _infer_stage(trainable):
        n_sur = (len(trainable["surrogates"])
                 if trainable.get("surrogates") else 0)
        return plan.num_stages - 1 - n_sur

    def stage_apply(frozen, trainable, inputs):
        # the static meta split for this stage, from the trainable tree
        t = _infer_stage(trainable)
        (f0, f1), (b0, b1), (a0, a1) = plan.stage_ranges(t)
        msplit = {"prefix": metas[f0:f1], "boundary": metas[b0:b1],
                  "active": metas[a0:a1]}
        return cnn_mod.cnn_stage_apply(frozen, trainable, ccfg, msplit,
                                       inputs)

    def full_loss(params, batch):
        return cnn_mod.cnn_loss(params["model"], ccfg, batch)

    def forward_eval(params, inputs):
        return cnn_mod.cnn_forward(params["model"], ccfg, inputs["images"])

    return Adapter(kind="cnn", cfg=ccfg, plan=plan, defs=defs,
                   num_classes=ccfg.num_classes, split_stage=split_stage,
                   merge_stage=merge_stage, stage_apply=stage_apply,
                   full_loss=full_loss, forward_eval=forward_eval)


def make_adapter(cfg, num_stages: int, boundary_units: int = 1) -> Adapter:
    if isinstance(cfg, cnn_mod.CNNConfig):
        return make_cnn_adapter(cfg, num_stages, boundary_units)
    return make_transformer_adapter(cfg, num_stages, boundary_units)


def make_stage_loss(adapter: Adapter, hp: cur.CurriculumHP, t: int):
    """loss(trainable, frozen, batch, global_ref) -> (loss, metrics)."""
    T = adapter.plan.num_stages

    def loss_fn(trainable, frozen, batch, global_ref):
        logits, feats = adapter.stage_apply(frozen, trainable,
                                            batch["inputs"])
        loss, metrics = cur.curriculum_loss(
            logits, feats, batch, adapter.cfg, hp, t, T, adapter.num_classes)
        prox = cur.proximal_term(trainable, global_ref, hp.mu)
        metrics["prox"] = prox
        return loss + prox, metrics

    return loss_fn


def _value_and_grad(loss_fn, params, *args):
    """(loss, aux, grads) of ``loss_fn(params, *args) -> (loss, aux)`` with
    respect to every leaf of ``params``.  A leaf the loss does not reach (an
    empty boundary slice) gets a zero gradient, as under ``jax.grad``."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = loss_fn(live, *args)
    leaves = tree_leaves(live)
    grads = tree_unflatten(live, [
        torch.zeros_like(p) if g is None else g for p, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))])
    return loss, aux, grads


def make_stage_step(adapter: Adapter, optimizer, hp: cur.CurriculumHP,
                    t: int):
    """train_step(opt_state, trainable, frozen, batch, global_ref)
    -> (opt_state, trainable, metrics), on tensors already on the device.
    Returns new trainable tensors; the inputs are not modified."""
    loss_fn = make_stage_loss(adapter, hp, t)

    def train_step(opt_state, trainable, frozen, batch, global_ref):
        loss, metrics, grads = _value_and_grad(loss_fn, trainable, frozen,
                                               batch, global_ref)
        updates, opt_state = optimizer.update(grads, opt_state, trainable)
        trainable = apply_updates(trainable, updates)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return opt_state, trainable, metrics

    return train_step


def make_full_step(adapter: Adapter, optimizer):
    """End-to-end (FedAvg) step over the whole model:
    train_step(opt_state, params, batch) -> (opt_state, params, {"loss"}),
    ``params`` a tree holding ``"model"`` (FedAvg passes ``{"model": ...}``
    alone; a leaf outside it gets a zero gradient).  Every layer keeps its
    activations for the backward: this is the step a NeuLite stage's memory
    is held against.  Returns new tensors; the inputs are not modified."""
    def loss_fn(params, batch):
        return adapter.full_loss(params, batch), None

    def train_step(opt_state, params, batch):
        loss, _, grads = _value_and_grad(loss_fn, params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return opt_state, params, {"loss": loss.detach()}

    return train_step
