"""Buffered-async FL (FedBuff-style) with client dropout at example scale
(port of the reference's ``examples/async_fedbuff.py``).

A heterogeneous 12-device fleet trains the paper's ResNet18 progressively.
The synchronous server waits for the slowest client every round; the
async server flushes its buffer every K deliveries with per-entry
staleness-discounted aggregation (true server versions behind) and never
waits for the tail: stragglers pending at a round's close stay in the
server's persistent buffer and aggregate in a later round.  Same data,
same model, less simulated time per round, and no slow client's work
vanishes.  A constant dropout schedule crashes ~15% of the selected
clients mid-round; their partial updates aggregate with completed-step
weights.  nHSIC runs through the kernels K1-K3 (their plain versions on
the CPU), where the reference's example runs its plain nHSIC.

  PYTHONPATH=src python -m repro_torch.examples.async_fedbuff

Environment knobs:

  FEDBUFF_ROUNDS=N       round budget (default 6)
  FEDBUFF_DEVICE=DEV     torch device (default: the CUDA card; "cpu")

Kill-and-resume harness: with ``FEDBUFF_CKPT=dir`` only the async leg
runs, checkpointing its complete server state every 2 rounds.
``FEDBUFF_KILL_AT=k`` SIGKILLs the process as round k opens (work past
the last checkpoint is lost and runs again); ``FEDBUFF_RESUME=1``
restores the newest checkpoint instead of starting afresh;
``FEDBUFF_COMPARE=other_dir`` then checks that the finished run's params,
server version, pending buffer and round history equal, to the bit,
those of the final checkpoint in ``other_dir`` (an uninterrupted run).

The third leg runs the async server with ``model_parallel=2`` in a
spawned world of 4 ranks (``launch.mesh.spawn_world``: a data 2 x model 2
mesh; on one card the ranks share it over gloo, on the CPU they use gloo)
and prints the mesh shape, the accuracy, the simulated seconds and the
server version.
"""
import dataclasses
import math
import os
import signal

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.tree import tree_leaves
from repro_torch.core.progressive import make_adapter
from repro_torch.data.loader import Batcher
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.federated.server import FLConfig, NeuLiteServer
from repro_torch.launch.mesh import spawn_world
from repro_torch.models.cnn import CNNConfig

# the reference's sizes
N_TRAIN, N_TEST, IMAGE_SIZE, WIDTH = 1200, 256, 8, 0.25
BASE = dict(n_devices=12, clients_per_round=6, local_epochs=1,
            batch_size=16, num_stages=2, seed=0, use_hsic_kernel=True)
ASYNC = dict(runtime="async", buffer_size=4,
             staleness_schedule="polynomial", staleness_alpha=0.5,
             dropout_schedule="constant", dropout_rate=0.15)
# the third leg: the async server on a (data 2, model 2) mesh of 4 ranks
MESH_WORLD = 4
ASYNC_MESH = dict(runtime="async", buffer_size=4,
                  staleness_schedule="polynomial", staleness_alpha=0.5,
                  model_parallel=2)


def setup(n_train=None, n_test=None):
    """(client datasets, test dataset, model config) of the example
    (``N_TRAIN`` / ``N_TEST`` images unless given)."""
    ds = make_image_dataset(0, N_TRAIN if n_train is None else n_train,
                            num_classes=10, image_size=IMAGE_SIZE)
    test = make_image_dataset(1, N_TEST if n_test is None else n_test,
                              num_classes=10, image_size=IMAGE_SIZE)
    parts = dirichlet_partition(0, ds.labels, BASE["n_devices"], alpha=1.0)
    ccfg = CNNConfig(name="resnet18", arch="resnet18", num_classes=10,
                     image_size=IMAGE_SIZE, width_mult=WIDTH)
    return [ds.subset(p) for p in parts], test, ccfg


def _server(flc, clients, test, ccfg, device, directory=None):
    kw = dict(test_batcher=Batcher(test, 128, kind="image"), device=device)
    adapter = make_adapter(ccfg, flc.num_stages)
    if directory is not None:
        return NeuLiteServer.restore(adapter, clients, flc, directory, **kw)
    return NeuLiteServer(adapter, clients, flc, **kw)


def same_run(a: NeuLiteServer, b: NeuLiteServer) -> dict:
    """Which of params, server version and clock, pending buffer and round
    history two async servers hold to the bit."""
    sa, sb = a.runtime.state, b.runtime.state

    def same_entry(x, y):
        return (x.stage == y.stage and x.weight == y.weight
                and x.pulled_version == y.pulled_version
                and x.arrival_time == y.arrival_time
                and x.cohort == y.cohort and torch.equal(
                    x.loss.cpu().reshape(()), y.loss.cpu().reshape(()))
                and all(torch.equal(p.cpu(), q.cpu()) for p, q in zip(
                    tree_leaves(x.delta), tree_leaves(y.delta),
                    strict=True)))

    def same_round(x, y):
        return all(u == v or (isinstance(u, float) and math.isnan(u)
                              and math.isnan(v))
                   for u, v in zip(dataclasses.astuple(x),
                                   dataclasses.astuple(y)))

    return {
        "params": all(torch.equal(p.cpu(), q.cpu()) for p, q in zip(
            tree_leaves(a.params), tree_leaves(b.params), strict=True)),
        "version": (sa.version, sa.clock) == (sb.version, sb.clock),
        "buffer": len(sa) == len(sb) and all(
            same_entry(x, y) for x, y in zip(sa.entries, sb.entries)),
        "history": len(a.history) == len(b.history) and all(
            same_round(x, y) for x, y in zip(a.history, b.history))}


def _sigkill():
    os.kill(os.getpid(), signal.SIGKILL)


def checkpointed_run(ckpt: str, rounds: int, kill_at: int = -1,
                     resume: bool = False, compare=None, device=None,
                     on_kill=_sigkill) -> NeuLiteServer:
    """The async leg checkpointing every 2 rounds into ``ckpt``, its final
    state into ``ckpt/final``: killed (``on_kill``) as round ``kill_at``
    opens, resumed from the newest checkpoint with ``resume``, and held to
    the bit against ``compare/final`` where given."""
    device = resolve_device(device)
    clients, test, ccfg = setup()
    flc = FLConfig(**BASE, **ASYNC, checkpoint_dir=ckpt, checkpoint_every=2)
    if resume:
        srv = _server(flc, clients, test, ccfg, device, ckpt)
        print(f"resumed at round {srv.next_round} (server version "
              f"{srv.runtime.state.version}, pending "
              f"{len(srv.runtime.state)})", flush=True)
    else:
        srv = _server(flc, clients, test, ccfg, device)
    while srv.next_round < rounds:
        if srv.next_round == kill_at:
            print(f"simulating host loss before round {kill_at}", flush=True)
            on_kill()
        srv.run(1, log_every=1)
    final_dir = os.path.join(ckpt, "final")
    srv.save_state(final_dir)
    print(f"final state -> {final_dir} (server version "
          f"{srv.runtime.state.version}, pending {len(srv.runtime.state)})",
          flush=True)
    if compare:
        ref = _server(flc, clients, test, ccfg, device,
                      os.path.join(compare, "final"))
        same = same_run(ref, srv)
        if not all(same.values()):
            raise AssertionError(f"the resumed run differs from the "
                                 f"uninterrupted one: {same}")
        print("kill-and-resume run matches the uninterrupted run exactly: "
              "params, server version, pending buffer and round history")
    return srv


def mesh_leg(device, rounds: int, n_train: int, n_test: int) -> dict:
    """One rank of the third leg: the async server with ``ASYNC_MESH`` on
    the world's (data, model) mesh; its mesh shape, final accuracy,
    simulated seconds and server version."""
    clients, test, ccfg = setup(n_train, n_test)
    srv = _server(FLConfig(**BASE, **ASYNC_MESH), clients, test, ccfg,
                  device)
    hist = srv.run(rounds, log_every=2)
    return {"mesh": dict(srv.mesh.shape), "acc": hist[-1].test_acc,
            "sim_time": sum(h.sim_time for h in hist),
            "server_version": srv.runtime.state.version,
            "held_trainable_bytes": srv.runtime.held_trainable_bytes}


def mesh_world(device=None, rounds: int = 6) -> dict:
    """The third leg in a spawned world of ``MESH_WORLD`` ranks (the card
    unless ``device="cpu"``); rank 0's ``mesh_leg``."""
    device = resolve_device(device)
    # on the CPU one torch thread a rank: the ranks share the cores
    return spawn_world(mesh_leg, MESH_WORLD, device, rounds, N_TRAIN,
                       N_TEST, threads=1 if device.type == "cpu" else None)[0]


def one_process_legs(device=None, rounds=None) -> dict:
    """The synchronous (vectorized) leg, then the async leg, in this
    process; returns their simulated times, the speedup and the async
    server's end state."""
    device = resolve_device(device)
    rounds = int(os.environ.get("FEDBUFF_ROUNDS", "6")
                 if rounds is None else rounds)
    clients, test, ccfg = setup()
    print("== synchronous (vectorized) ==", flush=True)
    flc = FLConfig(**BASE, runtime="vectorized")
    srv = _server(flc, clients, test, ccfg, device)
    hist = srv.run(rounds, log_every=2)
    sync_time = sum(h.sim_time for h in hist)
    sync_acc = hist[-1].test_acc

    print("\n== async (FedBuff: K=4, polynomial staleness, 15% dropout) ==",
          flush=True)
    flc = FLConfig(**BASE, **ASYNC)
    srv = _server(flc, clients, test, ccfg, device)
    hist = srv.run(rounds, log_every=2)
    async_time = sum(h.sim_time for h in hist)
    state = srv.runtime.state
    lost = sum(1 for h in hist if math.isnan(h.mean_loss))
    print(f"\nsimulated training time: sync {sync_time:.1f}s  "
          f"async {async_time:.1f}s  "
          f"speedup {sync_time / max(async_time, 1e-9):.2f}x")
    print(f"async final acc {hist[-1].test_acc:.3f} (lost rounds: {lost}, "
          f"server version {state.version}, still buffered {len(state)})")
    return {"sync_time": sync_time, "async_time": async_time,
            "speedup": sync_time / max(async_time, 1e-9),
            "sync_acc": sync_acc, "async_acc": hist[-1].test_acc,
            "lost_rounds": lost, "server_version": state.version,
            "pending": len(state), "history": hist}


def main(device=None, rounds=None) -> dict:
    """The three legs: ``one_process_legs``, then the async server on a
    (data 2, model 2) mesh in a spawned world (``mesh_world``); returns
    the first two legs' numbers and the third's under ``"mesh_leg"``."""
    device = resolve_device(device)
    rounds = int(os.environ.get("FEDBUFF_ROUNDS", "6")
                 if rounds is None else rounds)
    out = one_process_legs(device, rounds)
    print("\n== async x sharded (model_parallel=2, a world of "
          f"{MESH_WORLD}) ==", flush=True)
    leg = mesh_world(device, rounds)
    print(f"2-D async on mesh {leg['mesh']}: acc {leg['acc']:.3f}, "
          f"simulated {leg['sim_time']:.1f}s, server version "
          f"{leg['server_version']}", flush=True)
    return dict(out, mesh_leg=leg)


if __name__ == "__main__":
    device = os.environ.get("FEDBUFF_DEVICE") or None
    ckpt = os.environ.get("FEDBUFF_CKPT")
    if ckpt:
        checkpointed_run(ckpt, int(os.environ.get("FEDBUFF_ROUNDS", "6")),
                         int(os.environ.get("FEDBUFF_KILL_AT", "-1")),
                         bool(os.environ.get("FEDBUFF_RESUME")),
                         os.environ.get("FEDBUFF_COMPARE"), device)
    else:
        main(device)
