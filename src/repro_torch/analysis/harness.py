"""Audit harness: the runtimes' registry wired to the audit passes (port of
``repro.analysis.harness``).

``run_audits(backend, ...)`` builds small but real audit setups (the
reference's dense transformer of 8 layers at d_model 64 in 4 stages, or a
ResNet18 in 4 stages, ``CNN_SIZE``), asks the backend for its
round programs (``trace_specs`` / ``full_reference_spec``), runs every pass
over them (purity, held state, memory; on a mesh the collectives) and then
the host-sync probe over one real runtime round, one server round and one
evaluation.  Returns the ``Report`` the CLI renders.

The reference sized these models so that its static inequality holds (its
XLA peaks give max-stage / full ratios of ~0.70 for the transformer and
~0.78 for the CNN); on the card the pass measures the allocator's peaks
instead (``memory.audit_stage_peaks``).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np

from repro_torch.analysis import collectives as col
from repro_torch.analysis import donation as don
from repro_torch.analysis import hostsync as hs
from repro_torch.analysis import memory as mem
from repro_torch.analysis.report import Report
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core.curriculum import CurriculumHP
from repro_torch.data.loader import Batcher, stack_round
from repro_torch.federated.devices import DeviceProfile, MaterializedFleet
from repro_torch.federated.runtime import make_runtime
from repro_torch.federated.server import FLConfig, NeuLiteServer
from repro_torch.optim.optimizers import sgd

BACKENDS = {"seq": "sequential", "vec": "vectorized", "sharded": "sharded",
            "async": "async"}

# The audit ResNet18's (image size, width, batch).  The reference's (8,
# 0.125, 16) inverts the memory inequality on the card: the allocator's
# stage-3 peak is 1.009x the full step's (a fixed ~70 MB of workspaces in
# both, and at that width the surrogates and projectors weigh as much as
# the last block's savings; core.memory's estimate agrees, 1.08x).  At
# (32, 0.25, 32) the estimate's largest stage is 0.62x the full step.
CNN_SIZE = (32, 0.25, 32)


def tiny_setup(arch: str = "tx", device: DeviceLike = "cpu"):
    """(adapter, params, datasets, full_ds, data_kind, batch_size): the
    reference's audit models, params from seed 0 on ``device``."""
    from repro_torch.core.progressive import make_adapter
    dev = resolve_device(device)
    if arch == "tx":
        from repro_torch.data.synthetic import make_lm_dataset
        from repro_torch.models.config import ModelConfig
        cfg = ModelConfig(name="t", family="dense", num_layers=8,
                          d_model=64, num_heads=2, num_kv_heads=2,
                          d_ff=256, vocab_size=128, dtype="float32")
        adapter = make_adapter(cfg, 4)
        ds = make_lm_dataset(0, 96, 8, cfg.vocab_size)
        idx = np.arange(len(ds))
        datasets = [ds.subset(idx[i::3]) for i in range(3)]
        return adapter, adapter.init_params(0, dev), datasets, ds, "lm", 8
    if arch == "cnn":
        from repro_torch.data.partition import dirichlet_partition
        from repro_torch.data.synthetic import make_image_dataset
        from repro_torch.models.cnn import CNNConfig
        ccfg = CNNConfig(name="r18", arch="resnet18", num_classes=4,
                         image_size=CNN_SIZE[0], width_mult=CNN_SIZE[1])
        adapter = make_adapter(ccfg, 4)
        ds = make_image_dataset(0, 200, num_classes=4,
                                image_size=CNN_SIZE[0])
        parts = dirichlet_partition(0, ds.labels, 4, alpha=1.0)
        datasets = [ds.subset(p) for p in parts]
        return adapter, adapter.init_params(0, dev), datasets, ds, \
            "image", CNN_SIZE[2]
    raise ValueError(f"unknown arch {arch!r} (want 'tx' or 'cnn')")


def _runtime_kwargs(backend: str, model_parallel: int) -> dict:
    if backend == "sharded":
        return {"model_parallel": model_parallel}
    if backend == "async":
        return {"buffer_size": 0, "model_parallel": model_parallel}
    return {}


def audit_static(runtime, params, stack, report: Report, *,
                 stages: Optional[range] = None) -> None:
    """Run every stage's programs once through the passes: purity and held
    state on each, the collectives of each program on a mesh."""
    if stages is None:
        stages = range(runtime.adapter.plan.num_stages)
    audit_program(runtime.full_reference_spec(params, stack), report)
    summaries = []
    for t in stages:
        for spec in runtime.trace_specs(params, t, stack):
            if spec.mesh is not None and spec.data_axis is not None:
                with col.record_collectives() as records:
                    audit_program(spec, report)
                summaries.append(col.audit_collectives(
                    records, report, program=spec.name,
                    coords=col.mesh_coords(spec.mesh),
                    axis_names=spec.mesh.axis_names,
                    data_axis=spec.data_axis, kind=spec.kind,
                    n_agg_leaves=spec.n_agg_leaves))
            else:
                audit_program(spec, report)
        runtime.release()
    if summaries:
        report.artifacts["collectives"] = summaries


def audit_program(spec, report: Report) -> None:
    """The purity pass and, where the spec threads state, the held-state
    check, from one run of the program."""
    if not spec.alias_argnums:
        hs.purity_findings(spec, report)
        return
    mode = hs.PurityMode()
    don.audit_donation(spec, report, within=mode)
    hs.report_purity(mode, spec, report)


def audit_dynamic(backend: str, model_parallel: int, arch: str,
                  report: Report, device: DeviceLike = "cpu",
                  setup=None) -> None:
    """One real runtime round, one server round and one evaluation under
    the transfer probe (and, on the card, the sync debug mode), on
    ``setup`` (``tiny_setup(arch, device)`` unless given)."""
    adapter, params, datasets, full_ds, data_kind, bs = (
        setup if setup is not None else tiny_setup(arch, device))
    flc = FLConfig(n_devices=len(datasets),
                   clients_per_round=min(3, len(datasets)), local_epochs=1,
                   batch_size=bs, num_stages=adapter.plan.num_stages,
                   runtime=backend, model_parallel=model_parallel, seed=0)
    test_b = Batcher(full_ds, bs, seed=99, kind=data_kind)
    # every device fits every stage: the audited round selects clients
    fleet = MaterializedFleet([DeviceProfile(i, 1 << 40, 1.0)
                               for i in range(len(datasets))])
    server = NeuLiteServer(adapter, datasets, flc, test_batcher=test_b,
                           data_kind=data_kind, params=params,
                           device=device, fleet=fleet)
    cohorts = list(range(min(3, len(server.batchers))))
    # the hot-path contract first: the runtime itself never reads
    hs.audit_runtime_round(server.runtime, server.params, 0,
                           server.batchers, cohorts, 1, report)
    hs.audit_server_round(server, report)


def audit_memory_pass(runtime, params, stack, report: Report, *,
                      device: DeviceLike) -> None:
    """Every stage's allocator peak below the full step's on the stack's
    first cohort's batches (on the card); at ``model_parallel >= 2`` the
    held trainable bytes of the last round (``run_round`` first)."""
    batches = [tree_map(lambda x, e=e: x[0, e], stack.batches)
               for e in range(int(stack.num_batches[0]))]
    table = mem.audit_stage_peaks(report, runtime.adapter, params, batches,
                                  runtime.optimizer, hp=runtime.hp,
                                  device=device,
                                  program=f"{runtime.name}/local-training")
    K = getattr(runtime, "model_shards", 1)
    ratio = None
    if K > 1:
        t = runtime.adapter.plan.num_stages - 1
        trainable = runtime.adapter.split_stage(params, t)[1]
        ratio = mem.trainable_ratio(runtime, trainable)
        mem.audit_trainable(report, ratio, K, program=f"{runtime.name}"
                            f"/stage{t}")
    if table or ratio is not None:
        report.artifacts["memory"] = dict(table, trainable_ratio=ratio)


def run_audits(backend: str, *, model_parallel: int = 1, arch: str = "tx",
               waive=(), probe: bool = True, memory: bool = True,
               device: DeviceLike = None) -> Report:
    """Every audit pass for one backend on ``device`` (the card unless
    the caller passes ``"cpu"``); returns the ``Report``.  ``memory=False``
    skips the stage-peak measurement, which is the same for every backend
    (one client's eager local training)."""
    name = BACKENDS.get(backend, backend)
    if name not in BACKENDS.values():
        raise SystemExit(f"unknown backend {backend!r} "
                         f"(want one of {sorted(BACKENDS)})")
    dev = resolve_device(device)
    report = Report(waive=waive)
    setup = tiny_setup(arch, dev)
    adapter, params, datasets, _, data_kind, bs = setup
    optimizer = sgd(0.05, momentum=0.9, weight_decay=5e-4)
    hp = CurriculumHP(mu=0.01)
    runtime = make_runtime(name, adapter, optimizer, hp, dev,
                           **_runtime_kwargs(name, model_parallel))
    batchers = [Batcher(ds, bs, seed=i, kind=data_kind)
                for i, ds in enumerate(datasets)]
    stack = stack_round(batchers, range(len(batchers)), local_epochs=1)
    audit_static(runtime, params, stack, report)
    if getattr(runtime, "model_shards", 1) > 1:
        t = adapter.plan.num_stages - 1
        runtime.run_stacked(params, t, stack)     # held bytes of a round
        runtime.release()
    if memory:
        audit_memory_pass(runtime, params, stack, report, device=dev)
    if probe:
        audit_dynamic(name, model_parallel, arch, report, dev, setup)
    return report


def audit_next_round(runtime, probe: bool = True) -> dict:
    """Audit the next ``runtime.run_round`` of a runtime on a mesh (every
    rank calls it): its collectives, its host reads (``probe``) and the
    trainable bytes it held.  Returns a dict that the round fills with the
    report's ``to_dict()`` once it has run; later rounds run unaudited."""
    out = {}
    run = runtime.run_round

    def audited(params, t, *args, **kwargs):
        if out:
            return run(params, t, *args, **kwargs)
        report = Report()
        trainable = runtime.adapter.split_stage(params, t)[1]
        program = f"{runtime.name}.run_round"
        with contextlib.ExitStack() as stack:
            records = stack.enter_context(col.record_collectives())
            seen = stack.enter_context(hs.transfer_probe()) if probe \
                else None
            res = run(params, t, *args, **kwargs)
        mesh = runtime.mesh
        summary = col.audit_collectives(
            records, report, program=program,
            coords=col.mesh_coords(mesh), axis_names=mesh.axis_names,
            data_axis=getattr(runtime, "axis", "data"),
            n_agg_leaves=len(tree_leaves(trainable)))
        if seen is not None:
            hs.report_events(seen, report, program=program, expect_gets=0,
                             what="ClientRuntime.run_round",
                             max_consensus=1)
        ratio = mem.trainable_ratio(runtime, trainable)
        mem.audit_trainable(report, ratio, mesh.shape["model"],
                            program=f"{runtime.name}/stage{t}")
        report.artifacts.update(collectives=summary, trainable_ratio=ratio,
                                mesh=dict(mesh.shape), stage=t)
        out.update(report.to_dict())
        return res

    runtime.run_round = audited
    return out


def audited_mesh_round(device, backend: str = "sharded",
                       model_parallel: int = 2, arch: str = "tx") -> dict:
    """One audited round (``audit_next_round``) of ``backend`` at its last
    stage on the world's mesh, from ``tiny_setup``: what a rank of
    ``launch.mesh.spawn_world`` runs.  Returns the report's dict."""
    adapter, params, datasets, _, data_kind, bs = tiny_setup(arch, device)
    runtime = make_runtime(backend, adapter,
                           sgd(0.05, momentum=0.9, weight_decay=5e-4),
                           CurriculumHP(mu=0.01), device,
                           **_runtime_kwargs(backend, model_parallel))
    batchers = [Batcher(ds, bs, seed=i, kind=data_kind)
                for i, ds in enumerate(datasets)]
    out = audit_next_round(runtime)
    runtime.run_round(params, adapter.plan.num_stages - 1, batchers,
                      list(range(len(batchers))), 1)
    return out
