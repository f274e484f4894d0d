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
reference's rounds do.  The port has the sequential, vectorized, sharded
and buffered-async (FedBuff) runtimes and the random, TiFL and Oort
policies.

On a mesh of ranks (``runtime="sharded"``, or ``"async"`` with
``model_parallel > 1`` or in a world of more than one rank) every rank runs the same server (SPMD): the same
seed gives every rank the same params, cohorts and stacks, every rank
evaluates the same params, ``save_state`` writes on rank 0 only (then
waits at a barrier) and ``restore`` reads on every rank; ``run`` prints on
rank 0.

Crash safety: ``save_state`` checkpoints the complete round-loop state in
the reference's format (params in the reference's layout, through the
bridge; the async runtime's pending buffer too), so ``restore`` resumes a
killed run bit for bit, and a checkpoint written by either package
restores in the other.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint import (checkpoint_path, latest_checkpoint,
                                    load_checkpoint, read_checkpoint_meta,
                                    save_checkpoint)
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
from repro_torch.federated.runtime import (AsyncBufferedRuntime,
                                           AsyncServerState, ClientRuntime,
                                           make_runtime)
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
    boundary_units: int = 1
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
    runtime: str = "sequential"         # sequential | vectorized |
                                        # sharded | async
    model_parallel: int = 1             # sharded / async: model axis of
                                        # the (data, model) mesh
    # buffered-async (FedBuff) rounds; used when runtime == "async"
    buffer_size: int = 0                # flush every K deliveries (0: all
                                        # of a round's, synchronous); the
                                        # rest stay buffered for later
    staleness_schedule: str = "polynomial"   # constant | polynomial
    staleness_alpha: float = 0.5        # d(s) = (1 + s)^-alpha
    server_lr: float = 1.0              # scale on each flushed update
    max_staleness: Optional[int] = None  # evict buffered deltas more than
                                         # this many versions behind at
                                         # round open (None: never)
    dropout_schedule: str = "none"      # none | constant | ramp
    dropout_rate: float = 0.0           # per-client fault probability
    # crash safety: periodic exact server checkpoints (run())
    checkpoint_dir: Optional[str] = None  # save_state target; None = never
    checkpoint_every: int = 0           # save after round r when
                                        # (r + 1) % N == 0 (0 = never)
    keep_checkpoints: int = 3           # rotation depth in checkpoint_dir


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
    server_version: Optional[int] = None   # the async runtime's server
                                           # version; None on the
                                           # synchronous runtimes


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
        spec = runtime if runtime is not None else flc.runtime
        rt_kwargs = {}
        if spec == "async":
            rt_kwargs = dict(buffer_size=flc.buffer_size,
                             staleness_schedule=flc.staleness_schedule,
                             staleness_alpha=flc.staleness_alpha,
                             server_lr=flc.server_lr,
                             max_staleness=flc.max_staleness,
                             model_parallel=flc.model_parallel)
        elif spec == "sharded":
            rt_kwargs = dict(model_parallel=flc.model_parallel)
        self.runtime = make_runtime(spec, adapter, self.optimizer, self.hp,
                                    self.device, **rt_kwargs)
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
        if (isinstance(self.runtime, AsyncBufferedRuntime)
                and self.runtime.client_speeds is None):
            # the fleet's speeds drive the virtual clock (O(1) state)
            self.runtime.client_speeds = self.fleet
        self.history: List[RoundResult] = []
        self.next_round: int = 0

    @property
    def mesh(self):
        """The runtime's mesh of ranks, ``None`` in one process."""
        return getattr(self.runtime, "mesh", None)

    @property
    def is_rank0(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

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
        new_fleet = MaterializedFleet(profiles)
        if (isinstance(self.runtime, AsyncBufferedRuntime)
                and self.runtime.client_speeds is self.fleet):
            self.runtime.client_speeds = new_fleet
        self.fleet = new_fleet
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
        state = getattr(self.runtime, "state", None)
        if state is not None and not getattr(self.schedule,
                                             "revisits_stages", True):
            # a monotone schedule never returns to an earlier stage: its
            # pending async deltas could never flush
            state.drop_retired_stages(t)
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
            if out.round_sim_time is not None:
                # async: open to the last flush (0 when it only buffered),
                # never the slowest straggler
                sim_times = [out.round_sim_time]
            else:
                speeds = self.fleet.speeds(selected)
                sim_times = [nb / s
                             for s, nb in zip(speeds, out.num_batches)]
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
                         test_acc=acc, server_version=getattr(
                             getattr(self.runtime, "state", None),
                             "version", None))
        self.history.append(rr)
        self.next_round = r + 1
        return rr

    def run(self, rounds: int, log_every: int = 0) -> List[RoundResult]:
        """Run ``rounds`` further rounds starting at ``self.next_round`` (0
        on a fresh server, the resume point after ``restore``); with
        ``log_every`` print every ``log_every``-th round.  With
        ``flc.checkpoint_dir`` set and ``flc.checkpoint_every > 0`` the
        round-loop state is saved after every ``checkpoint_every``-th
        round, so a killed process resumes from the last visible
        checkpoint."""
        flc = self.flc
        start = self.next_round
        for r in range(start, start + rounds):
            rr = self.run_round(r)
            if log_every and (r % log_every == 0) and self.is_rank0:
                print(f"round {r:4d} stage {rr.stage} "
                      f"loss {rr.mean_loss:.4f} acc {rr.test_acc} "
                      f"feasible {rr.n_feasible}/{self.flc.n_devices}")
            if (flc.checkpoint_dir is not None and flc.checkpoint_every > 0
                    and (r + 1) % flc.checkpoint_every == 0):
                self.save_state(flc.checkpoint_dir)
        return self.history

    # crash safety: exact checkpoint and resume of the round loop
    _STATE_FORMAT = "neulite-server"
    _STATE_VERSION = 1

    def _kinds(self) -> dict:
        return {"runtime": self.runtime.name,
                "num_stages": int(self.adapter.plan.num_stages),
                "schedule_kind": type(self.schedule).__name__,
                "selector_kind": type(self.selector).__name__}

    def save_state(self, directory: str, *, step: Optional[int] = None,
                   keep: Optional[int] = None) -> str:
        """Checkpoint the state that decides the next rounds' bits: the
        params (in the reference's layout), the server's RNG, the schedule
        and selector state, every client batcher's RNG and the test
        batcher's (which ``evaluate`` consumes), the history and the
        resume point; the reference's format, so its ``load_state`` reads
        it.  A round keeps no graph or optimizer state across rounds (each
        captures anew and makes its SGD state), so none is saved.  The
        ``async`` slot holds the async runtime's pending buffer
        (``AsyncServerState.state_dict``: stacked deltas in the
        reference's layout and per-entry metadata; on a model-sharded
        mesh gathered whole), ``None`` on the synchronous runtimes.
        ``step`` defaults to ``next_round``, ``keep`` to
        ``flc.keep_checkpoints``.  On a mesh every rank calls it, rank 0
        writes, and every rank returns the path after a barrier."""
        meta = {
            "format": self._STATE_FORMAT,
            "state_version": self._STATE_VERSION,
            "next_round": int(self.next_round),
            **self._kinds(),
            "rng": self.rng.bit_generator.state,
            "schedule": self.schedule.state_dict(),
            "selector": self.selector.state_dict(),
            "history": [dataclasses.asdict(rr) for rr in self.history],
            "async": None,
            "batcher_rngs": None,
            "test_batcher_rng": None,
        }
        tree = {}
        state = getattr(self.runtime, "state", None)
        if state is not None:
            # a collective on a model-sharded mesh: every rank gathers
            tree["async"], meta["async"] = self.runtime.checkpoint_state()
        if isinstance(self.batchers, (list, tuple)):
            meta["batcher_rngs"] = [b.rng.bit_generator.state
                                    for b in self.batchers]
        if self.test_batcher is not None and hasattr(self.test_batcher,
                                                     "rng"):
            meta["test_batcher_rng"] = (
                self.test_batcher.rng.bit_generator.state)
        step = self.next_round if step is None else step
        if self.is_rank0:
            tree["params"] = bridge.reference_layout(self.params)
            path = save_checkpoint(
                directory, step, tree, meta=meta,
                keep=self.flc.keep_checkpoints if keep is None else keep)
        else:
            path = checkpoint_path(directory, step)
        if self.mesh is not None:
            self.mesh.barrier()
        return path

    def load_state(self, path: str) -> None:
        """Install the state ``save_state`` (of either package) wrote.  The
        server must have been built with the run's configuration: the
        runtime, stage count and schedule and selector kinds are checked,
        then every mutable part is overwritten."""
        meta = read_checkpoint_meta(path)
        if not isinstance(meta, dict) or meta.get("format") \
                != self._STATE_FORMAT:
            raise ValueError(
                f"{path!r} is not a NeuLiteServer state checkpoint "
                f"(save_state writes format={self._STATE_FORMAT!r}; plain "
                f"param checkpoints cannot resume a round loop)")
        for key, have in self._kinds().items():
            if meta.get(key) != have:
                raise ValueError(
                    f"checkpoint/server mismatch on {key}: saved "
                    f"{meta.get(key)!r}, this server has {have!r} — "
                    f"rebuild the server with the run's original config")
        if meta["async"] is not None and not hasattr(self.runtime,
                                                     "load_server_state"):
            raise ValueError(
                f"{path!r} holds an async runtime's buffer, but this "
                f"server's {self.runtime.name} runtime has no buffer to "
                f"restore it into")
        batcher_rngs = meta["batcher_rngs"]
        if batcher_rngs is not None and (
                not isinstance(self.batchers, (list, tuple))
                or len(self.batchers) != len(batcher_rngs)):
            held = (len(self.batchers)
                    if isinstance(self.batchers, (list, tuple)) else 0)
            raise ValueError(
                f"checkpoint carries {len(batcher_rngs)} client batcher RNG "
                f"states but this server holds {held} materialized "
                f"batchers")
        like = {"params": self.params}
        if meta["async"] is not None:
            like["async"] = AsyncServerState.arrays_like(
                self.adapter, self.params, meta["async"])
        tree, _ = load_checkpoint(path, like, device="cpu")
        self.params = bridge.from_reference(tree["params"], self.device)
        if meta["async"] is not None:
            self.runtime.load_server_state(AsyncServerState.from_state_dict(
                meta["async"], tree["async"], self.device))
        self.rng.bit_generator.state = meta["rng"]
        self.schedule.load_state_dict(meta["schedule"])
        self.selector.load_state_dict(meta["selector"])
        self.history = [RoundResult(**h) for h in meta["history"]]
        self.next_round = int(meta["next_round"])
        if batcher_rngs is not None:
            for b, state in zip(self.batchers, batcher_rngs):
                b.rng.bit_generator.state = state
        if (meta["test_batcher_rng"] is not None
                and self.test_batcher is not None
                and hasattr(self.test_batcher, "rng")):
            self.test_batcher.rng.bit_generator.state = (
                meta["test_batcher_rng"])

    @classmethod
    def restore(cls, adapter, client_datasets, flc: FLConfig,
                directory: str, **kwargs) -> "NeuLiteServer":
        """A server built from its constructor's arguments (``kwargs`` are
        ``__init__``'s, as the run was built) and the newest complete
        checkpoint in ``directory`` (or a ``ckpt_*.npz`` path); its
        ``run(n)`` continues from the checkpointed round."""
        if directory.endswith(".npz"):
            path = directory
        else:
            path = latest_checkpoint(directory)
            if path is None:
                raise FileNotFoundError(
                    f"no complete checkpoint found in {directory!r}")
        server = cls(adapter, client_datasets, flc, **kwargs)
        server.load_state(path)
        return server

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
