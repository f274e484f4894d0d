"""Progressive-training engine: the CNN adapter and the stage train step
(port of ``repro.core.progressive``).

An ``Adapter`` binds a model family to the NeuLite engine.  It owns the
combined ParamDef tree (model, output-module surrogates, nHSIC projectors),
``split_stage(params, t) -> (frozen, trainable)``, ``merge_stage(params,
trainable, t)`` and ``stage_apply(frozen, trainable, inputs)``.  Params are
dict trees of tensors with the reference's keys and nesting.

``make_stage_step`` takes gradients and optimizer state over the trainable
subtree only; the frozen prefix is a plain forward input run under
``torch.no_grad``, so it keeps no activations, gradients or optimizer state.
That is the paper's memory claim.
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
from repro_torch.optim.optimizers import apply_updates


@dataclasses.dataclass
class Adapter:
    kind: str                       # "cnn"
    cfg: Any
    plan: BlockPlan
    defs: dict
    num_classes: int
    split_stage: Callable[[Any, int], tuple]
    merge_stage: Callable[[Any, Any, int], Any]
    stage_apply: Callable[[Any, Any, dict], tuple]
    forward_eval: Callable[[Any, dict], torch.Tensor]

    def init_params(self, seed: int, device: DeviceLike = None):
        return PD.init_params(seed, self.defs, device)


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

    def forward_eval(params, inputs):
        return cnn_mod.cnn_forward(params["model"], ccfg, inputs["images"])

    return Adapter(kind="cnn", cfg=ccfg, plan=plan, defs=defs,
                   num_classes=ccfg.num_classes, split_stage=split_stage,
                   merge_stage=merge_stage, stage_apply=stage_apply,
                   forward_eval=forward_eval)


def make_adapter(cfg, num_stages: int, boundary_units: int = 1) -> Adapter:
    if not isinstance(cfg, cnn_mod.CNNConfig):
        raise ValueError("the port has the CNN adapter only; the transformer "
                         "adapter comes with a later part of the port")
    return make_cnn_adapter(cfg, num_stages, boundary_units)


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


def make_stage_step(adapter: Adapter, optimizer, hp: cur.CurriculumHP,
                    t: int):
    """train_step(opt_state, trainable, frozen, batch, global_ref)
    -> (opt_state, trainable, metrics), on tensors already on the device.
    Returns new trainable tensors; the inputs are not modified."""
    loss_fn = make_stage_loss(adapter, hp, t)

    def train_step(opt_state, trainable, frozen, batch, global_ref):
        live = tree_map(lambda p: p.detach().requires_grad_(True), trainable)
        loss, metrics = loss_fn(live, frozen, batch, global_ref)
        grads = tree_unflatten(live, torch.autograd.grad(
            loss, tree_leaves(live)))
        updates, opt_state = optimizer.update(grads, opt_state, trainable)
        trainable = apply_updates(trainable, updates)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return opt_state, trainable, metrics

    return train_step
