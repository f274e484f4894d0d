"""Baseline FL methods the paper compares against, Tables 1-2 (port of
``repro.federated.baselines``).

All baselines train the CNN zoo on cross-entropy alone (the paper's
setting); none runs an nHSIC kernel:

  FedAvg       vanilla FL, no memory awareness (reference upper bound —
               impractical under the memory wall)
  AllSmall     width-scale the global model to the *minimum* device memory;
               everyone trains the small model (inclusive)
  ExclusiveFL  only devices that fit FULL-model training participate
  DepthFL      depth-scaled sub-models w/ per-depth heads; per-unit aggregation
  HeteroFL     static width scaling (channel slices) per device tier
  FedRolex     rolling width scaling — window start advances each round
  TiFL         tier-based selection (full model → non-inclusive)
  Oort         utility-based selection (full model → non-inclusive)
  ProgFed      progressive growth w/o freezing, fixed interval, CE only

Width slicing uses a uniform per-axis channel-index rule; for concatenating
architectures (SqueezeNet fire modules) the slice is approximate, which is
the "width scaling compromises the architecture" failure the paper reports
for SqueezeNet.  The port keeps conv weights OIHW, (cout, cin, k, k), where
the reference slices HWIO, (k, k, cin, cout): the same rule reads axis 1
for cin and axis 0 for cout.  A model's widths come from its params, never
from ``width_mult``: a sub-model's config is a label.

Every method runs on ``device`` (the card unless the caller passes
``"cpu"``), with eager steps; HeteroFL's scatter-average stays on the
device in float64.  On a CUDA device cuDNN is made deterministic, as the
server makes it, so a run repeats bit for bit.  ``params`` (and ``heads``
for DepthFL and ProgFed) start a method from given params, e.g. the
reference's through ``bridge.from_reference``; by default they are drawn
from ``flc.seed``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.common import paramdef as PD
from repro_torch.common.device import DeviceLike, resolve_device, to_device
from repro_torch.common.tree import flatten_paths, map_with_path
from repro_torch.core.memory import estimate_full_memory
from repro_torch.core.progressive import _value_and_grad, make_cnn_adapter
from repro_torch.data.loader import Batcher
from repro_torch.federated import aggregation as agg
from repro_torch.federated.client import run_local_training_full
from repro_torch.federated.devices import sample_devices
from repro_torch.federated.selection import (OortState, memory_feasible,
                                             oort_select, oort_update,
                                             random_select, tifl_select)
from repro_torch.models import cnn as cnn_mod
from repro_torch.models.cnn import CNNConfig
from repro_torch.models.layers import cross_entropy
from repro_torch.optim.optimizers import apply_updates, sgd


@dataclasses.dataclass
class BaselineResult:
    accuracies: List[float]
    participation_rate: float
    name: str

    @property
    def final_acc(self) -> float:
        tail = self.accuracies[-10:] if len(self.accuracies) >= 10 \
            else self.accuracies
        return float(np.mean(tail)) if tail else 0.0


def _sgd_step(optimizer, loss):
    """The reference's jitted value_and_grad + SGD step, eager:
    step(opt_state, params, batch) -> (opt_state, params, {"loss"})."""
    def step(opt_state, params, batch):
        lv, _, grads = _value_and_grad(lambda p, b: (loss(p, b), None),
                                       params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return opt_state, apply_updates(params, updates), {
            "loss": lv.detach()}

    return step


def _prefix_logits(ccfg: CNNConfig, metas, bundle, images):
    """Logits of a unit prefix and its own head (DepthFL, ProgFed)."""
    x = cnn_mod.cnn_apply_units(ccfg, metas, bundle["units"],
                                cnn_mod.nchw(images))
    return cnn_mod.linear(bundle["head"], x.mean(dim=(2, 3)))


class _Base:
    """Shared harness: fleet, partitions, eval."""

    name = "base"
    inclusive = False

    def __init__(self, ccfg: CNNConfig, client_datasets, test_batcher,
                 flc, params=None, device: DeviceLike = None):
        self.ccfg = ccfg
        self.flc = flc
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # cuDNN's default conv algorithms are nondeterministic
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.rng = np.random.default_rng(flc.seed)
        self.adapter = make_cnn_adapter(ccfg, flc.num_stages)
        self.test_batcher = test_batcher
        self.batchers = [Batcher(ds, flc.batch_size, seed=flc.seed + i)
                         for i, ds in enumerate(client_datasets)]
        full_mem = estimate_full_memory(self.adapter, flc.batch_size)
        self.full_req = full_mem.total
        self.devices = sample_devices(flc.seed, flc.n_devices, self.full_req)
        self.optimizer = sgd(flc.lr, flc.momentum, flc.weight_decay)
        self.params = (params if params is not None else PD.init_params(
            flc.seed, cnn_mod.cnn_defs(ccfg), self.device))
        self._full_step = None
        self.feasible_hist: List[int] = []

    def full_step(self, ccfg=None):
        if self._full_step is None:
            cfg = ccfg or self.ccfg
            self._full_step = _sgd_step(
                self.optimizer,
                lambda params, batch: cnn_mod.cnn_loss(params, cfg, batch))
        return self._full_step

    @torch.no_grad()
    def _accuracy(self, logits_fn, max_batches: int) -> float:
        """Accuracy of ``logits_fn(images)`` over up to ``max_batches``
        test batches; the hits add up on the device and are read once."""
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        total = 0
        for i, batch in enumerate(self.test_batcher.epoch()):
            if i >= max_batches:
                break
            labels = np.asarray(batch["labels"])
            logits = logits_fn(to_device(batch["inputs"]["images"],
                                         self.device))
            correct += (logits.argmax(-1)
                        == to_device(labels, self.device)).sum()
            total += len(labels)
        return int(correct.item()) / max(total, 1)

    def evaluate(self, params=None, ccfg=None, max_batches: int = 8) -> float:
        cfg = ccfg or self.ccfg
        p = params if params is not None else self.params
        return self._accuracy(
            lambda imgs: cnn_mod.cnn_forward(p, cfg, imgs), max_batches)

    def select(self, candidates, r) -> List[int]:
        return random_select(self.rng, candidates,
                             self.flc.clients_per_round)

    def candidates(self, r) -> List[int]:
        return memory_feasible(self.devices, self.full_req)

    def run(self, rounds: int) -> BaselineResult:
        accs = []
        for r in range(rounds):
            cands = self.candidates(r)
            self.feasible_hist.append(len(cands))
            selected = self.select(cands, r)
            self.round(r, selected)
            accs.append(self.evaluate())
        pr = float(np.mean(self.feasible_hist)) / self.flc.n_devices
        return BaselineResult(accs, pr, self.name)

    def _train(self, step, params, cid):
        return run_local_training_full(step, self.optimizer, params,
                                       self.batchers[cid],
                                       self.flc.local_epochs, self.device)

    def round(self, r: int, selected: List[int]):
        if not selected:
            return
        results, weights = [], []
        for cid in selected:
            res = self._train(self.full_step(), self.params, cid)
            results.append(res.trainable)
            weights.append(res.num_samples)
            self._post_client(cid, res, r)
        self.params = agg.weighted_average(results, weights)

    def _post_client(self, cid, res, r):
        pass


class FedAvg(_Base):
    name = "fedavg"
    inclusive = True

    def candidates(self, r):
        return [d.device_id for d in self.devices]   # memory-oblivious


class ExclusiveFL(_Base):
    name = "exclusivefl"


class TiFL(_Base):
    name = "tifl"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.credits: Dict[int, int] = {t: 10 ** 9 for t in range(5)}

    def select(self, candidates, r):
        return tifl_select(self.rng, self.devices, candidates,
                           self.flc.clients_per_round, credits=self.credits)


class Oort(_Base):
    name = "oort"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.oort = OortState()

    def select(self, candidates, r):
        return oort_select(self.rng, self.devices, candidates,
                           self.flc.clients_per_round, self.oort, r)

    def _post_client(self, cid, res, r):
        # one read of the device per client, as the reference's
        oort_update(self.oort, cid, float(res.mean_loss), r)


class AllSmall(_Base):
    name = "allsmall"
    inclusive = True

    def __init__(self, ccfg, client_datasets, test_batcher, flc,
                 params=None, **kw):
        super().__init__(ccfg, client_datasets, test_batcher, flc, **kw)
        min_mem = min(d.mem_bytes for d in self.devices)
        ratio = max(0.125, min(1.0, min_mem / self.full_req))
        width = float(np.sqrt(ratio))        # memory ~ width², roughly
        self.small_cfg = dataclasses.replace(ccfg, width_mult=width,
                                             name=ccfg.name + "-small")
        self.params = (params if params is not None else PD.init_params(
            flc.seed, cnn_mod.cnn_defs(self.small_cfg), self.device))
        self._full_step = None

    def full_step(self, ccfg=None):
        return super().full_step(ccfg=self.small_cfg)

    def evaluate(self, params=None, ccfg=None, max_batches: int = 8):
        return super().evaluate(params, self.small_cfg, max_batches)

    def candidates(self, r):
        return [d.device_id for d in self.devices]


# --------------------------------------------------------------------------- #
# width scaling (HeteroFL / FedRolex)
# --------------------------------------------------------------------------- #
_WIDTH_LEVELS = (1.0, 0.5, 0.25, 0.125)


def _channel_idx(c: int, ratio: float, offset: int) -> np.ndarray:
    k = max(1, int(round(c * ratio)))
    return (offset + np.arange(k)) % c


def _slice_leaf(path: str, leaf, ratio: float, offset: int,
                num_classes: int, in_channels: int):
    """Slice every 'channel-like' axis of a CNN leaf by the width ratio.
    Returns the slice and its ``(axis, indices)`` maps, in the order the
    axes were sliced (cin before cout)."""
    if leaf.ndim == 0:
        return leaf, ()
    axes = []
    if leaf.ndim == 4:                     # conv (cout, cin, k, k)
        if leaf.shape[1] != in_channels:
            axes.append(1)
        axes.append(0)
    elif leaf.ndim == 2:                   # linear (cin, cout)
        axes.append(0)
        if leaf.shape[1] != num_classes:
            axes.append(1)
    elif leaf.ndim == 1:                   # gn scale/bias or linear bias
        if leaf.shape[0] != num_classes:
            axes.append(0)
    idx_map = []
    for ax in axes:
        idx = _channel_idx(leaf.shape[ax], ratio, offset % leaf.shape[ax])
        leaf = leaf.index_select(ax, torch.as_tensor(idx,
                                                     device=leaf.device))
        idx_map.append((ax, idx))
    return leaf.contiguous(), tuple(idx_map)


def _extract_submodel(params, ratio: float, offset: int, num_classes: int,
                      in_channels: int):
    maps = {}

    def visit(p, leaf):
        arr, m = _slice_leaf(p, leaf, ratio, offset, num_classes,
                             in_channels)
        maps[p] = m
        return arr

    return map_with_path(visit, params), maps


class WidthScatterMean:
    """HeteroFL's aggregation: each client's sliced tree scattered back
    through its index maps into float64 sums and counts of the global
    shape, then ``where(count > 0, sum / count, global)`` cast back.  On
    the params' device; clients add one after another in the order given.
    Within one client an axis' indices are distinct, so plain indexed adds
    (no atomics) give each sum its bits in a fixed order."""

    def __init__(self, params):
        self.params = params
        flat = flatten_paths(params)
        self.sums = {p: torch.zeros_like(v, dtype=torch.float64)
                     for p, v in flat.items()}
        self.counts = {p: torch.zeros_like(v, dtype=torch.float64)
                       for p, v in flat.items()}

    def add(self, sub, maps) -> None:
        for p, leaf in flatten_paths(sub).items():
            arr = leaf.double()
            s, c = self.sums[p], self.counts[p]
            idxs = maps[p]
            if not idxs:
                s += arr
                c += 1.0
                continue
            # an open mesh of the per-axis indices (the outer product), its
            # dims in axis order, so that it lines up with the slice (the
            # sliced axes are adjacent)
            ix = [slice(None)] * s.ndim
            order = sorted(ax for ax, _ in idxs)
            for ax, m in idxs:
                shape = [1] * len(order)
                shape[order.index(ax)] = len(m)
                ix[ax] = torch.as_tensor(m, device=s.device).reshape(shape)
            ix = tuple(ix)
            s[ix] += arr
            c[ix] += 1.0

    def result(self):
        def avg(p, v):
            c = self.counts[p]
            return torch.where(c > 0, self.sums[p] / c.clamp_min(1),
                               v.double()).to(v.dtype)

        return map_with_path(avg, self.params)


class HeteroFL(_Base):
    name = "heterofl"
    inclusive = True

    rolling = False

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.client_ratio = {}
        for d in self.devices:
            frac = d.mem_bytes / self.full_req
            ratio = next((lv for lv in _WIDTH_LEVELS if lv * lv * 1.2 <= frac),
                         _WIDTH_LEVELS[-1])
            self.client_ratio[d.device_id] = ratio

    def candidates(self, r):
        return [d.device_id for d in self.devices]

    def _offset(self, r: int) -> int:
        return r if self.rolling else 0

    def round(self, r: int, selected: List[int]):
        if not selected:
            return
        acc = WidthScatterMean(self.params)
        offset = self._offset(r)
        for cid in selected:
            ratio = self.client_ratio[cid]
            sub, maps = _extract_submodel(self.params, ratio, offset,
                                          self.ccfg.num_classes,
                                          self.ccfg.in_channels)
            # one step for every ratio: the forward takes its widths from
            # the sliced params (the reference's per-ratio config is a label)
            res = self._train(self.full_step(), sub, cid)
            acc.add(res.trainable, maps)
        self.params = acc.result()


class FedRolex(HeteroFL):
    name = "fedrolex"
    rolling = True


# --------------------------------------------------------------------------- #
# depth scaling (DepthFL / ProgFed)
# --------------------------------------------------------------------------- #
class _Depth(_Base):
    """Prefixes of the unit list (the plan's block ends), each with its own
    classifier head drawn from ``flc.seed + HEAD_SEED + end``."""

    HEAD_SEED = 0

    def __init__(self, *a, heads=None, **kw):
        super().__init__(*a, **kw)
        self.metas = cnn_mod.unit_meta(self.ccfg)
        self.bounds = list(self.adapter.plan.bounds)
        self.depth_ends = [e for _, e in self.bounds]
        self.heads = (list(heads) if heads is not None else [
            PD.init_params(self.flc.seed + self.HEAD_SEED + e,
                           cnn_mod.linear_defs(self.metas[e - 1][1]["cout"],
                                               self.ccfg.num_classes),
                           self.device)
            for e in self.depth_ends])
        self._steps: Dict[int, Callable] = {}

    def _step(self, lvl: int):
        if lvl not in self._steps:
            metas = self.metas[:self.depth_ends[lvl]]
            ccfg = self.ccfg

            def loss(bundle, batch):
                logits = _prefix_logits(ccfg, metas, bundle,
                                        batch["inputs"]["images"])
                return cross_entropy(logits, batch["labels"])

            self._steps[lvl] = _sgd_step(self.optimizer, loss)
        return self._steps[lvl]


class DepthFL(_Depth):
    """Depth-scaled sub-models: D depth levels (== plan bounds prefixes),
    each with its own classifier head; per-unit weighted aggregation."""
    name = "depthfl"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        # per-client depth level by memory (prefix fraction of full req)
        self.client_level = {}
        for d in self.devices:
            frac = d.mem_bytes / self.full_req
            lvl = 0
            for li in range(len(self.depth_ends)):
                if frac >= (li + 1) / len(self.depth_ends) * 1.1:
                    lvl = li
            self.client_level[d.device_id] = lvl

    def candidates(self, r):
        # DepthFL's PR < 100%: devices below the smallest prefix skip
        min_req = self.full_req / len(self.depth_ends) * 0.8
        return [d.device_id for d in self.devices
                if d.mem_bytes >= min_req]

    def round(self, r: int, selected: List[int]):
        if not selected:
            return
        unit_updates: List[List] = [[] for _ in self.metas]
        unit_weights: List[List] = [[] for _ in self.metas]
        head_updates: Dict[int, list] = {}
        for cid in selected:
            lvl = self.client_level[cid]
            end = self.depth_ends[lvl]
            bundle = {"units": self.params["units"][:end],
                      "head": self.heads[lvl]}
            res = self._train(self._step(lvl), bundle, cid)
            for u in range(end):
                unit_updates[u].append(res.trainable["units"][u])
                unit_weights[u].append(res.num_samples)
            head_updates.setdefault(lvl, []).append(
                (res.trainable["head"], res.num_samples))
        units = list(self.params["units"])
        for u in range(len(units)):
            if unit_updates[u]:
                units[u] = agg.weighted_average(unit_updates[u],
                                                unit_weights[u])
        self.params = dict(self.params)
        self.params["units"] = units
        for lvl, ups in head_updates.items():
            self.heads[lvl] = agg.weighted_average(
                [t for t, _ in ups], [w for _, w in ups])
        # deepest head doubles as the global model's head for evaluation
        self.params["head"] = self.heads[-1]


class ProgFed(_Depth):
    """ProgFed (Wang et al. 2022): progressive *growth* without freezing —
    stage s trains units [0, end_s) jointly with a stage head; growth every
    ``rounds_per_stage`` rounds; plain CE loss."""
    name = "progfed"
    inclusive = True
    HEAD_SEED = 17

    def stage(self, r: int) -> int:
        return min(r // self.flc.rounds_per_stage, len(self.depth_ends) - 1)

    def candidates(self, r):
        # memory need grows with the stage (no freezing!)
        s = self.stage(r)
        req = self.full_req * self.depth_ends[s] / len(self.metas)
        return memory_feasible(self.devices, int(req))

    def round(self, r: int, selected: List[int]):
        if not selected:
            return
        s = self.stage(r)
        end = self.depth_ends[s]
        results, weights = [], []
        for cid in selected:
            bundle = {"units": self.params["units"][:end],
                      "head": self.heads[s]}
            res = self._train(self._step(s), bundle, cid)
            results.append(res.trainable)
            weights.append(res.num_samples)
        avg = agg.weighted_average(results, weights)
        units = list(self.params["units"])
        units[:end] = avg["units"]
        self.params = dict(self.params)
        self.params["units"] = units
        self.heads[s] = avg["head"]
        self.params["head"] = self.heads[-1] if s == len(self.depth_ends) - 1 \
            else self.params["head"]

    def evaluate(self, params=None, ccfg=None, max_batches: int = 8):
        # the prefix model at the current stage's head; the stage comes
        # from the rounds run so far (the reference's rule)
        s = self.stage(len(self.feasible_hist) - 1) if self.feasible_hist \
            else 0
        metas = self.metas[:self.depth_ends[s]]
        bundle = {"units": self.params["units"][:self.depth_ends[s]],
                  "head": self.heads[s]}
        return self._accuracy(
            lambda imgs: _prefix_logits(self.ccfg, metas, bundle, imgs),
            max_batches)


BASELINES = {
    "fedavg": FedAvg,
    "exclusivefl": ExclusiveFL,
    "allsmall": AllSmall,
    "depthfl": DepthFL,
    "heterofl": HeteroFL,
    "fedrolex": FedRolex,
    "tifl": TiFL,
    "oort": Oort,
    "progfed": ProgFed,
}
