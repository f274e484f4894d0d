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

``jit_stage_step`` and ``jit_full_step`` are the reference's jitted steps
with opt-state donation; in the port they are the same steps captured as
CUDA graphs (``CapturedStep``), replayed with no Python per op: the host
issues one graph launch a step instead of hundreds of ops.
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

    def init_params(self, seed: int, device: DeviceLike = None, *,
                    draw_on_device: bool = False):
        return PD.init_params(seed, self.defs, device,
                              draw_on_device=draw_on_device)


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
        if "embed" in params["model"]:            # none for audio
            (trainable if t == 0 else frozen)["embed"] = \
                params["model"]["embed"]
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


# =========================================================================== #
# the step as one captured program (CUDA graphs)
# =========================================================================== #
WARMUP_STEPS = 2    # eager runs on a side stream before a capture


def donation_supported(device: DeviceLike = None) -> bool:
    """Whether ``device`` (the current card by default) can capture a step
    as a CUDA graph: the port's counterpart of the reference's question,
    which CPU XLA answers no, as the CPU does here."""
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cuda" and torch.cuda.is_available()


def _kernel_launches():
    """The ``LAUNCHES`` counters of the port's kernel wrappers."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.hsic_gram import kernel as hkernel
    from repro_torch.kernels.slstm_scan import kernel as skernel
    return (hkernel.LAUNCHES, fkernel.LAUNCHES, skernel.LAUNCHES)


def _snapshot():
    return [dict(c) for c in _kernel_launches()]


_STREAMS = {}


def _capture_stream(device):
    """One side stream a device for every warm-up and capture: PyTorch
    keeps a cuBLAS workspace (64 MiB) for each stream a product ran on, for
    the process's life, so a new stream per capture would add one each."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


def _static_copy(t):
    return t.detach().clone(memory_format=torch.contiguous_format)


class _Graph:
    """One capture of a step at one set of argument shapes: the static
    argument trees the graph reads (the first ``carried`` of them are also
    what it writes its new values into; those at the ``shared`` positions
    are the caller's own tensors, read in place), its scalar outputs, and
    the kernel launches it recorded."""

    def __init__(self, fn, args, carried: int, name: str, shared=()):
        self.carried = carried
        self.shared = frozenset(shared)
        self.static = [a if i in self.shared else tree_map(_static_copy, a)
                       for i, a in enumerate(args)]
        before = _snapshot()
        side = _capture_stream(tree_leaves(list(args))[0].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                fn(*self.static)
        torch.cuda.current_stream().wait_stream(side)
        warm = _snapshot()
        # torch.cuda.graph synchronizes and empties the cache (the
        # warm-ups' blocks) before it captures
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, stream=side):
                metrics = self._body(fn)
        except Exception as err:
            raise RuntimeError(
                f"{name}: capturing the step as a CUDA graph failed at "
                f"argument shapes {_shapes_of(args)}: {err}") from err
        self.keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
        self.dtypes = [metrics[k].dtype for k in self.keys]
        self.constants = {k: v for k, v in metrics.items()
                          if not torch.is_tensor(v)}
        after = _snapshot()
        # warm-ups and capture are set-up, not steps: their launches do
        # not count; every replay adds what the capture recorded
        self.launches = [{n: a[n] - w[n] for n in a if a[n] != w[n]}
                         for a, w in zip(after, warm)]
        for counts, b in zip(_kernel_launches(), before):
            counts.update(b)

    def _body(self, fn):
        """What the graph records: one step on the static arguments, its
        carried outputs written into the first ``carried`` of them, its
        tensor metrics stacked into ``self.vector``.  Returns the metrics."""
        out = fn(*self.static)
        for dst, src in zip(self.static[:self.carried],
                            out[:self.carried]):
            for d, v in zip(tree_leaves(dst), tree_leaves(src)):
                d.copy_(v)
        metrics = out[self.carried]
        self.vector = torch.stack([v.float() for v in metrics.values()
                                   if torch.is_tensor(v)])
        return metrics

    def load(self, args) -> None:
        """Copy each argument into its static buffers, unless it is those
        buffers (the carried outputs of the last replay) or read in place:
        one multi-tensor copy a tree, not one launch a leaf."""
        for i, (arg, static) in enumerate(zip(args, self.static)):
            if i in self.shared:
                continue
            src, dst = tree_leaves(arg), tree_leaves(static)
            if all(a is b for a, b in zip(src, dst)):
                continue
            torch._foreach_copy_(dst, src)

    def replay(self):
        self.graph.replay()
        for counts, rec in zip(_kernel_launches(), self.launches):
            for n, k in rec.items():
                counts[n] += k
        values = self.vector.clone().unbind()
        metrics = dict(self.constants)
        metrics.update({k: v.to(d) for k, v, d in
                        zip(self.keys, values, self.dtypes)})
        return (*self.static[:self.carried], metrics)


def _shapes_of(args):
    return [tuple(t.shape) for t in tree_leaves(list(args))]


def _signature(args):
    return tuple((tuple(t.shape), t.dtype, t.device)
                 for t in tree_leaves(list(args)))


def _addresses(args, shared):
    """Where the leaves of the ``shared`` arguments lie: a graph that reads
    them in place serves only calls with these same tensors."""
    return tuple((t.data_ptr(), t.stride()) for i in sorted(shared)
                 for t in tree_leaves(args[i]))


class CapturedStep:
    """``step(*args) -> (*carried, metrics)`` replayed from CUDA graphs,
    one per shape of its arguments, captured at the first call with those
    shapes (after ``WARMUP_STEPS`` eager runs on a side stream, which
    also make the kernels' one-time ``cudaFuncSetAttribute`` calls).

    The graph reads static copies of every argument, copied in at every
    call, and writes the first ``carried`` outputs (opt_state and the
    trained params) into the static copies of the first ``carried``
    arguments, in place: the port's form of the reference's donation.  So
    the returned trees are the graph's buffers, rewritten by the next
    replay: a caller that keeps one past the next call copies it
    (``own_outputs``).  The arguments at the ``shared`` positions (the
    frozen prefix and ``global_ref``, the same tensors for every client of
    a round) are not copied: the graph reads the caller's tensors in place,
    so a call with other tensors there captures anew (the graph it
    replaces is dropped first; the runtimes ``release`` theirs after every
    round, so within one they hold one graph a batch shape).  Tensor
    metrics come back as fresh tensors.  A capture that fails raises,
    naming the shapes: the step never continues eagerly.  ``LAUNCHES`` of
    the kernel wrappers gain, per replay, the launches recorded at
    capture.  ``release`` drops the graphs and their pools; the trees
    returned before stay valid."""

    def __init__(self, step: Callable, carried: int = 2, name: str = "step",
                 shared=()):
        self.step = step
        self.carried = carried
        self.name = name
        self.shared = tuple(shared)
        self.graphs = {}

    @property
    def reuses_outputs(self) -> bool:
        """Whether a later call may rewrite the trees returned so far: only
        while a graph is held."""
        return bool(self.graphs)

    def release(self) -> None:
        self.graphs.clear()

    def __call__(self, *args):
        shapes = _signature(args)
        key = (shapes, _addresses(args, self.shared))
        graph = self.graphs.get(key)
        if graph is None:
            for stale in [k for k in self.graphs if k[0] == shapes]:
                del self.graphs[stale]
            graph = self.graphs[key] = _Graph(self.step, args, self.carried,
                                              self.name, self.shared)
        graph.load(args)
        return graph.replay()


def own_outputs(step, tree):
    """``tree`` (a step's output) as its caller may keep it past the step's
    next call: a copy where the step reuses its output buffers (a
    ``CapturedStep`` holding its graphs), else ``tree`` itself."""
    if getattr(step, "reuses_outputs", False):
        return tree_map(torch.clone, tree)
    return tree


def jit_stage_step(adapter: Adapter, optimizer, hp: cur.CurriculumHP,
                   t: int, *, donate: bool = True,
                   donate_trainable: bool = False,
                   device: DeviceLike = None):
    """``make_stage_step`` as one captured program: on a CUDA device a
    ``CapturedStep`` (CUDA-graph capture, not TorchScript), one graph per
    batch shape, its optimizer updating ``opt_state`` in place (the
    reference donates it); on the CPU, or with ``donate=False``, the eager
    step itself.

    ``donate_trainable=False`` is the default for the reference's reason:
    FL callers alias ``trainable`` with ``global_ref`` on the first local
    step.  The captured step keeps its own static copy of ``trainable``
    and reads ``frozen`` and ``global_ref`` in place (``shared``); it writes
    only its own buffers and has no counterpart of donating the caller's
    ``trainable``, so True raises."""
    step = make_stage_step(adapter, optimizer, hp, t)
    if not (donate and donation_supported(device)):
        return step
    if donate_trainable:
        raise NotImplementedError(
            "jit_stage_step: the captured step keeps a static trainable "
            "buffer of its own; donating the caller's has no counterpart")
    return CapturedStep(step, name=f"stage {t} step", shared=(2, 4))


def jit_full_step(adapter: Adapter, optimizer, *, donate: bool = True,
                  donate_params: bool = False, device: DeviceLike = None):
    """``make_full_step`` as one captured program, as ``jit_stage_step``
    captures the stage step (the same aliasing caveats)."""
    step = make_full_step(adapter, optimizer)
    if not (donate and donation_supported(device)):
        return step
    if donate_params:
        raise NotImplementedError(
            "jit_full_step: the captured step keeps a static params buffer "
            "of its own; donating the caller's has no counterpart")
    return CapturedStep(step, name="full-model step")
