"""NeuLite FL server: progressive rounds with memory-aware participation
(port of ``repro.federated.server``; paper Fig. 1 and Alg. 1).

  1. Model construction  — stage t from the schedule; split params into
                           (frozen, trainable).
  2. Local training      — selected clients run E epochs of Eq. 5.
  3. Model aggregation   — Eq. 1 weighted FedAvg over the trainable subtree.
  4. Progress evaluation — validation metric feeds the schedule.
  5. Model growing       — next stage (round-robin by default).

``RoundResult.mean_loss`` is the |D_c|-weighted mean of client losses.  Each
round reads the device once, for its losses; ``evaluate`` reads it once.
On a CUDA device the server makes cuDNN deterministic (deterministic
algorithms, no autotuning), so a run repeats bit for bit, as the
reference's rounds do.  The port has the sequential and vectorized
runtimes and the random, TiFL and Oort policies; checkpointing and the
async and sharded runtimes come with later parts.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device, to_device
from repro_torch.core.curriculum import CurriculumHP
from repro_torch.core.memory import (estimate_full_memory,
                                     estimate_stage_memory)
from repro_torch.core.schedule import (PlateauSchedule, RoundRobinSchedule,
                                       SequentialSchedule)
from repro_torch.data.loader import Batcher
from repro_torch.federated import aggregation as agg
from repro_torch.federated.client import dropout_prob, sample_fault_steps
from repro_torch.federated.devices import Fleet, MaterializedFleet
from repro_torch.federated.runtime import ClientRuntime, make_runtime
from repro_torch.federated.selection import SelectionPolicy, make_policy
from repro_torch.optim.optimizers import sgd


@dataclasses.dataclass
class FLConfig:
    n_devices: int = 100
    clients_per_round: int = 10
    local_epochs: int = 5
    batch_size: int = 32
    lr: float = 0.05
    momentum: float = 0.9
    weight_decay: float = 5e-4
    num_stages: int = 4
    schedule: str = "round_robin"       # round_robin | plateau | sequential
    rounds_per_stage: int = 10          # for sequential
    curriculum: bool = True             # ablation: w/o CA
    co_adaptation: bool = True          # ablation: w/o PC
    mu: float = 0.01
    lambda1: float = 2.0
    lambda2: float = 1.0
    use_hsic_kernel: bool = False       # nHSIC through the CUDA kernels
    alpha: float = 1.0                  # Dirichlet concentration
    selection: str = "random"           # round-open cohort policy
    seed: int = 0
    runtime: str = "sequential"
    dropout_schedule: str = "none"      # none | constant | ramp
    dropout_rate: float = 0.0           # per-client fault probability


@dataclasses.dataclass
class RoundResult:
    round_idx: int
    stage: int
    n_selected: int
    n_feasible: int
    mean_loss: float
    upload_bytes: int
    sim_time: float
    test_acc: Optional[float] = None


class NeuLiteServer:
    """``client_datasets`` is a list of per-client datasets (wrapped into
    ``Batcher``s) or a lazy bank with ``bank[cid] -> Batcher`` (such as
    ``data.partition.ProceduralClients``).  ``params``
    starts the server from given params (e.g. converted reference params);
    by default the adapter inits them from ``flc.seed``.  ``device`` is the
    current CUDA card unless the caller passes another (``"cpu"``).
    ``runtime`` (a name or a ``ClientRuntime``) overrides ``flc.runtime``;
    ``fleet`` overrides the streaming fleet (e.g. a ``MaterializedFleet``
    over given profiles) and ``selection_policy`` ``flc.selection``."""

    def __init__(self, adapter, client_datasets, flc: FLConfig,
                 test_batcher: Optional[Batcher] = None,
                 data_kind: str = "image",
                 runtime: Union[str, ClientRuntime, None] = None,
                 fleet: Optional[Fleet] = None,
                 selection_policy: Optional[SelectionPolicy] = None,
                 params=None, device: DeviceLike = None):
        self.adapter = adapter
        self.flc = flc
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # cuDNN's default conv algorithms are nondeterministic
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.rng = np.random.default_rng(flc.seed)
        self.params = (adapter.init_params(flc.seed, self.device)
                       if params is None else params)
        self.optimizer = sgd(flc.lr, flc.momentum, flc.weight_decay)
        self.hp = CurriculumHP(lambda1_max=flc.lambda1,
                               lambda2_max=flc.lambda2, mu=flc.mu,
                               enabled=flc.curriculum,
                               use_hsic_kernel=flc.use_hsic_kernel)
        self.runtime = make_runtime(
            runtime if runtime is not None else flc.runtime, adapter,
            self.optimizer, self.hp, self.device)
        self.test_batcher = test_batcher
        if isinstance(client_datasets, (list, tuple)):
            self.batchers = [Batcher(ds, flc.batch_size, seed=flc.seed + i,
                                     kind=data_kind)
                             for i, ds in enumerate(client_datasets)]
        else:
            self.batchers = client_datasets
        T = adapter.plan.num_stages
        if not flc.co_adaptation:
            self.schedule = SequentialSchedule(T, flc.rounds_per_stage)
        elif flc.schedule == "round_robin":
            self.schedule = RoundRobinSchedule(T)
        elif flc.schedule == "plateau":
            self.schedule = PlateauSchedule(T)
        else:
            self.schedule = SequentialSchedule(T, flc.rounds_per_stage)
        full_mem = estimate_full_memory(adapter, flc.batch_size,
                                        seq=self._seq_len())
        self.fleet = (fleet if fleet is not None
                      else Fleet(flc.seed, flc.n_devices, full_mem.total))
        self.selector = (selection_policy if selection_policy is not None
                         else make_policy(flc.selection))
        self._devices = None
        self.history: List[RoundResult] = []
        self.next_round: int = 0

    @property
    def devices(self):
        """The fleet's ``DeviceProfile`` list, built on first use
        (O(population); the round loop never builds it)."""
        if self._devices is None:
            self._devices = self.fleet.profiles(range(self.fleet.n_devices))
        return self._devices

    @devices.setter
    def devices(self, profiles):
        # given profiles (Table 2 reuses a smaller model's budgets) must
        # reach selection: they replace the fleet, not only this view
        self.fleet = MaterializedFleet(profiles)
        self._devices = list(profiles)

    def _seq_len(self) -> int:
        """Sequence length for the memory model (0 for image tasks)."""
        ds = self.batchers[0].ds if self.batchers else None
        toks = getattr(ds, "tokens", None)
        return 0 if toks is None else toks.shape[1] - 1

    def stage_mem_requirement(self, t: int) -> int:
        return estimate_stage_memory(self.adapter, t, self.flc.batch_size,
                                     seq=self._seq_len()).total

    def run_round(self, r: int) -> RoundResult:
        flc = self.flc
        t = self.schedule.stage(r)
        req = self.stage_mem_requirement(t)
        selected, n_feasible = self.selector.select(
            self.rng, self.fleet, flc.clients_per_round, req, r)

        if selected:
            faults = None
            prob = dropout_prob(flc.dropout_schedule, flc.dropout_rate, r)
            if prob > 0:
                targets = [flc.local_epochs
                           * self.batchers[cid].steps_per_epoch
                           for cid in selected]
                faults = sample_fault_steps(self.rng, targets, prob)
            out = self.runtime.run_round(self.params, t, self.batchers,
                                         selected, flc.local_epochs,
                                         faults=faults)
            self.params = out.params
            n_up = (out.n_uploads if out.n_uploads is not None
                    else len(selected))
            upload = agg.tree_bytes(out.trainable) * n_up
            # the round's one host sync: mean loss and cohort losses together
            losses = torch.cat([out.mean_loss.reshape(1).float(),
                                out.cohort_losses.float()]).cpu().numpy()
            mean_loss = float(losses[0])
            speeds = self.fleet.speeds(selected)
            sim_times = [nb / s for s, nb in zip(speeds, out.num_batches)]
            self.selector.observe(selected, losses[1:1 + len(selected)], r)
        else:
            upload, mean_loss, sim_times = 0, float("nan"), []

        acc = None
        if self.test_batcher is not None:
            acc = self.evaluate()
            self.schedule.observe(r, 1.0 - acc)
        else:
            self.schedule.observe(r, mean_loss)

        rr = RoundResult(round_idx=r, stage=t, n_selected=len(selected),
                         n_feasible=n_feasible, mean_loss=mean_loss,
                         upload_bytes=upload,
                         sim_time=float(max(sim_times)) if sim_times else 0.0,
                         test_acc=acc)
        self.history.append(rr)
        self.next_round = r + 1
        return rr

    def run(self, rounds: int, log_every: int = 0) -> List[RoundResult]:
        """Run ``rounds`` further rounds starting at ``self.next_round``;
        with ``log_every`` print every ``log_every``-th round."""
        start = self.next_round
        for r in range(start, start + rounds):
            rr = self.run_round(r)
            if log_every and (r % log_every == 0):
                print(f"round {r:4d} stage {rr.stage} "
                      f"loss {rr.mean_loss:.4f} acc {rr.test_acc} "
                      f"feasible {rr.n_feasible}/{self.flc.n_devices}")
        return self.history

    @torch.no_grad()
    def evaluate(self, max_batches: int = 8) -> float:
        """Accuracy over valid positions (``batch["mask"]`` or labels >= 0)
        of up to ``max_batches`` test batches.  Counts accumulate on the
        device and are read once."""
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        total = 0
        for i, batch in enumerate(self.test_batcher.epoch()):
            if i >= max_batches:
                break
            labels = np.asarray(batch["labels"])
            mask = batch.get("mask")
            mask = (labels >= 0) if mask is None else np.asarray(mask, bool)
            logits = self.adapter.forward_eval(
                self.params, to_device(batch["inputs"], self.device))
            hit = ((logits.argmax(-1) == to_device(labels, self.device))
                   & to_device(mask, self.device))
            correct += hit.sum()
            total += int(mask.sum())
        if total == 0:
            return 0.0
        return int(correct.item()) / total

    @property
    def participation_rate(self) -> float:
        if not self.history:
            return 0.0
        return float(np.mean([h.n_feasible / self.flc.n_devices
                              for h in self.history]))
