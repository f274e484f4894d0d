"""Per-rank bodies of rounds on a mesh, for ``launch.mesh.spawn_world``.

Every rank of a world runs the same body on the same inputs (SPMD) and
returns what it computed, on the host, in the reference's layout
(``bridge.to_reference``), so that a caller in another process (a test
holding the port against the reference, a benchmark) compares it without
the ranks' devices.  Inputs cross as numpy trees and the port's own
dataclasses (``RoundStack``, ``FLConfig`` fields), never as anything of the
reference's package.

  stacked_rounds  runtimes' ``run_stacked`` on prepared stacks: the sharded
                  runtime on every stage, the buffered-async runtime over a
                  sequence of rounds, each round's aggregate, losses,
                  held bytes and (async) host numbers and buffer
  server_runs     ``NeuLiteServer`` runs: straight, killed-and-restored
                  from a checkpoint written on this world, or restored from
                  a checkpoint written elsewhere
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.common.tree import tree_leaves


def build_adapter(model):
    """``(kind, config fields, stages)`` -> the port's adapter: ``kind``
    ``"cnn"`` (``CNNConfig``) or ``"transformer"`` (``ModelConfig``)."""
    from repro_torch.core.progressive import make_adapter
    kind, fields, stages = model
    if kind == "cnn":
        from repro_torch.models.cnn import CNNConfig
        return make_adapter(CNNConfig(**fields), stages)
    from repro_torch.models.config import ModelConfig
    return make_adapter(ModelConfig(**fields), stages)


def _np(tree):
    return bridge.to_reference(tree) if tree is not None else None


def _buffer(runtime) -> List[Dict[str, Any]]:
    """The async buffer's entries on the host, deltas whole."""
    arrays, meta = runtime.checkpoint_state()
    entries, cursor = [], {}
    for s in meta["stages"]:
        i = cursor.get(s, 0)
        cursor[s] = i + 1
        g = arrays[f"stage_{s}"]
        entries.append(dict(
            stage=int(s), weight=float(g["weight"][i]),
            pulled_version=int(g["pulled_version"][i]),
            arrival_time=float(g["arrival_time"][i]),
            cohort=int(g["cohort"][i]), loss=float(g["loss"][i]),
            delta=[np.asarray(x[i]) for x in tree_leaves(g["delta"])]))
    return entries


HOST_METRICS = ("n_pending", "n_uploads", "n_carried", "n_evicted",
                "server_version", "sim_round_time")


def stacked_rounds(device: torch.device, cases: List[dict]) -> List[dict]:
    """Each case: ``model`` (``build_adapter``), ``params`` (a numpy tree in
    the reference's layout), ``lr``, ``hp`` (``CurriculumHP`` fields),
    ``runtime`` (``"sharded"`` or ``"async"``) and ``runtime_kw``, and
    ``rounds``: a list of ``{"t", "stack", "sim_times"?}``, each run with
    ``run_stacked`` from the case's params (``chain``: from the last
    round's merged params).  ``drift_rank`` perturbs that rank's first
    stack, so that the round must refuse on every rank.  Per round: the
    new trainable and the merged params (the reference's layout), the
    mean and cohort losses, ``held_trainable_bytes``, and on the async
    runtime its host numbers and buffer; a refused round's error text."""
    from repro_torch.core.curriculum import CurriculumHP
    from repro_torch.federated.runtime import make_runtime
    from repro_torch.optim.optimizers import sgd
    out = []
    for case in cases:
        adapter = build_adapter(case["model"])
        start = bridge.from_reference(case["params"], device)
        runtime = make_runtime(
            case["runtime"], adapter, sgd(case["lr"], 0.9, 5e-4),
            CurriculumHP(**case["hp"]), device, **case.get("runtime_kw", {}))
        rank = 0 if runtime.mesh is None else runtime.mesh.rank
        params, rows = start, []
        for j, rnd in enumerate(case["rounds"]):
            stack = rnd["stack"]
            if j == 0 and case.get("drift_rank") == rank:
                stack = dataclasses.replace(
                    stack, weights=np.asarray(stack.weights) * 2.0)
            kw = ({"sim_times": rnd["sim_times"]}
                  if "sim_times" in rnd else {})
            try:
                new, m = runtime.run_stacked(params, rnd["t"], stack, **kw)
            except RuntimeError as e:
                rows.append({"error": str(e)})
                continue
            merged = adapter.merge_stage(params, new, rnd["t"])
            row = dict(t=rnd["t"], trainable=_np(new), merged=_np(merged),
                       mean_loss=float(m["mean_local_loss"]),
                       cohort_losses=m["cohort_losses"].cpu().numpy(),
                       held_trainable_bytes=runtime.held_trainable_bytes)
            if case["runtime"] == "async":
                row.update({k: m[k] for k in HOST_METRICS},
                           staleness=np.asarray(m["staleness"]).tolist(),
                           buffer=_buffer(runtime))
            rows.append(row)
            if case.get("chain"):
                params = merged
        out.append(dict(name=case["name"], rank=rank,
                        mesh=None if runtime.mesh is None
                        else dict(runtime.mesh.shape), rounds=rows))
    return out


def _image_data(data: dict):
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_image_dataset
    ds = make_image_dataset(data["seed"], data["n"],
                            num_classes=data["classes"],
                            image_size=data["image_size"])
    parts = dirichlet_partition(data["seed"], ds.labels, data["clients"],
                                alpha=1.0)
    test = make_image_dataset(data["test_seed"], data["test_n"],
                              num_classes=data["classes"],
                              image_size=data["image_size"])
    return [ds.subset(p) for p in parts], test


def _server(case, device, directory=None):
    from repro_torch.data.loader import Batcher
    from repro_torch.federated.devices import Fleet
    from repro_torch.federated.server import FLConfig, NeuLiteServer
    clients, test = _image_data(case["data"])
    flc = FLConfig(**case["flc"])
    kw = dict(test_batcher=Batcher(test, 32, seed=7, kind="image"),
              fleet=Fleet(*case["fleet"]), device=device)
    adapter = build_adapter(case["model"])
    if directory is not None:
        return NeuLiteServer.restore(adapter, clients, flc, directory, **kw)
    return NeuLiteServer(adapter, clients, flc, **kw)


def _server_state(srv) -> dict:
    """What decides a server's next rounds, on the host."""
    out = dict(params=_np(srv.params),
               history=[dataclasses.asdict(h) for h in srv.history],
               rng=srv.rng.bit_generator.state,
               next_round=srv.next_round,
               mesh=None if srv.mesh is None else dict(srv.mesh.shape),
               held_trainable_bytes=getattr(srv.runtime,
                                            "held_trainable_bytes", None))
    state = getattr(srv.runtime, "state", None)
    if state is not None:
        out.update(version=state.version, clock=state.clock,
                   buffer=_buffer(srv.runtime))
    return out


def server_runs(device: torch.device, cases: List[dict]) -> List[dict]:
    """Each case: ``model``, ``data`` (``_image_data``), ``flc``
    (``FLConfig`` fields), ``fleet`` (``Fleet`` arguments) and ``rounds``.
    A server runs ``rounds`` rounds one at a time; with ``checkpoint_dir``
    and ``checkpoint_every`` in ``flc`` it saves its state as ``run``
    does (rank 0 writes) and its state at each save is kept
    (``saved[round]``); with ``resume_at`` a second server restored on
    every rank from that round's checkpoint runs to ``rounds``
    (``resumed``).  With ``restore_from`` (a directory or a checkpoint)
    the first server is restored from it instead (``restored``: its
    state right after).  Returns each case's ``_server_state``s:
    ``final``, ``saved``, and ``restored`` / ``resumed`` where asked."""
    from repro_torch.checkpoint import checkpoint_path
    out = []
    for case in cases:
        res = {"name": case["name"], "saved": {}}
        every = case["flc"].get("checkpoint_every", 0)
        srv = _server(case, device, case.get("restore_from"))
        if "restore_from" in case:
            res["restored"] = _server_state(srv)
        end = srv.next_round + case["rounds"]
        while srv.next_round < end:
            srv.run(1)
            if every and srv.next_round % every == 0:
                res["saved"][srv.next_round] = _server_state(srv)
        res["final"] = _server_state(srv)
        if "resume_at" in case:
            srv = _server(case, device, checkpoint_path(
                case["flc"]["checkpoint_dir"], case["resume_at"]))
            srv.run(end - srv.next_round)
            res["resumed"] = _server_state(srv)
        out.append(res)
    return out


def rounds_and_servers(device: torch.device, stacked: List[dict],
                       servers: List[dict]) -> List[dict]:
    """``stacked_rounds`` of ``stacked``, then ``server_runs`` of
    ``servers``, on one rank: a world's cases of both kinds."""
    return stacked_rounds(device, stacked) + server_runs(device, servers)
