"""The server's selection policies, fleet and runtime arguments, and the
paper's Tables 1-2 and Fig. 7 benchmarks, the port against the JAX
reference.

Servers with ``selection="tifl"`` and ``"oort"`` run two rounds on the
``test_torch_round`` setup (ResNet18 at width 0.125, 8x8, 2 stages), the
port from the reference's params: the same cohorts and feasible counts,
and params within 1e-3 of the largest update.  The tables run at a tiny
size (ResNet18/34 at width 0.125, 8x8, 2 rounds; the reference's module
fixes 16x16, so its data and config are shrunk to 8x8 here through the
names its module imports): participation rates and full-model-feasible
counts equal the reference's exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import benchmarks.common as r_bcommon
import benchmarks.table1_accuracy as r_table1
import benchmarks.table2_complexity as r_table2
from repro.data import dirichlet_partition, make_image_dataset
from repro.federated.server import FLConfig as RFLConfig
from repro.federated.server import NeuLiteServer as RServer
from repro_torch import bridge
from repro_torch.benchmarks import fig7_time, table1_accuracy, table2_complexity
from repro_torch.core.progressive import make_adapter as t_make_adapter
from repro_torch.federated.devices import Fleet, MaterializedFleet
from repro_torch.federated.runtime import (AsyncBufferedRuntime,
                                           SequentialRuntime)
from repro_torch.federated.selection import OortPolicy, TiFLPolicy
from repro_torch.federated.server import FLConfig as TFLConfig
from repro_torch.federated.server import NeuLiteServer as TServer
from repro_torch.models.cnn import CNNConfig as TConfig

TOL = 1e-3
FL = dict(n_devices=20, clients_per_round=3, local_epochs=1, batch_size=8,
          lr=0.05, num_stages=2, mu=0.01, seed=0)
T_CFG = TConfig(name="r18", arch="resnet18", num_classes=4, image_size=8,
                width_mult=0.125)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one thread here: the port's side is many small ops, which
    several test processes sharing the cores slow down many times over
    when each runs a pool of threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clients():
    ds = make_image_dataset(0, 200, num_classes=4, image_size=8)
    parts = dirichlet_partition(0, ds.labels, FL["n_devices"], alpha=1.0)
    return [ds.subset(p) for p in parts]


def _port_server(clients, params=None, **kw):
    flc = TFLConfig(**{**FL, **kw.pop("fl", {})}, use_hsic_kernel=True)
    return TServer(t_make_adapter(T_CFG, flc.num_stages), clients, flc,
                   params=params, device="cpu", **kw)


def _update_rel_err(ref_new, ref_start, port_new):
    r_new = [np.asarray(a, np.float64)
             for a in jax.tree.leaves(jax.device_get(ref_new))]
    r_old = [np.asarray(a, np.float64) for a in jax.tree.leaves(ref_start)]
    t_new = [np.asarray(a, np.float64)
             for a in jax.tree.leaves(bridge.to_reference(port_new))]
    r_upd = [a - s for a, s in zip(r_new, r_old)]
    t_upd = [b - s for b, s in zip(t_new, r_old)]
    scale = max(np.abs(u).max() for u in r_upd)
    assert scale > 0
    return max(float(np.abs(a - b).max())
               for a, b in zip(r_upd, t_upd, strict=True)) / scale


@pytest.fixture(scope="module", params=["tifl", "oort"])
def policy_servers(request, cnn_setup, clients):
    adapter = cnn_setup[0]
    ref = RServer(adapter, clients, RFLConfig(**FL,
                                              selection=request.param))
    start = jax.device_get(ref.params)
    port = _port_server(clients, params=bridge.from_reference(start, "cpu"),
                        fl={"selection": request.param})
    ref.run(2)
    port.run(2)
    return request.param, ref, port, start


def test_selection_policy_rounds_match(policy_servers):
    name, ref, port, start = policy_servers
    assert type(port.selector).__name__ == type(ref.selector).__name__
    for rh, th in zip(ref.history, port.history, strict=True):
        assert (rh.stage, rh.n_selected, rh.n_feasible, rh.upload_bytes) \
            == (th.stage, th.n_selected, th.n_feasible, th.upload_bytes)
        assert rh.sim_time == pytest.approx(th.sim_time, rel=1e-12)
        assert abs(th.mean_loss - rh.mean_loss) <= TOL * abs(rh.mean_loss)
    assert ref.rng.bit_generator.state == port.rng.bit_generator.state
    assert _update_rel_err(ref.params, start, port.params) <= TOL
    assert ref.participation_rate == port.participation_rate


def test_selection_policy_state_matches(policy_servers):
    """TiFL's credits and Oort's utilities after two rounds: the same keys
    and, for Oort, losses at the round rule."""
    name, ref, port, _ = policy_servers
    r_state, t_state = ref.selector.state_dict(), port.selector.state_dict()
    if name == "tifl":
        assert r_state == t_state
    else:
        assert r_state["last_round"] == t_state["last_round"]
        assert r_state["util"].keys() == t_state["util"].keys()
        for c, u in r_state["util"].items():
            assert t_state["util"][c] == pytest.approx(u, rel=TOL)


def test_devices_setter_reaches_selection(clients):
    srv = _port_server(clients)
    full = srv.fleet.full_model_bytes
    assert [d.device_id for d in srv.devices] == list(range(FL["n_devices"]))
    # budgets of a fleet for a 4x smaller model: far fewer devices fit
    small = Fleet(FL["seed"], FL["n_devices"], full // 4).profiles(
        range(FL["n_devices"]))
    srv.devices = small
    assert isinstance(srv.fleet, MaterializedFleet)
    assert srv.devices == small
    req = srv.stage_mem_requirement(0)
    want = sum(d.mem_bytes >= req for d in small)
    rr = srv.run_round(0)
    assert rr.n_feasible == want < FL["n_devices"]
    assert srv.participation_rate == want / FL["n_devices"]


def test_participation_rate_is_the_mean_feasible_share(clients):
    srv = _port_server(clients, fl={"num_stages": 2})
    assert srv.participation_rate == 0.0
    hist = srv.run(2, log_every=1)
    assert srv.participation_rate == pytest.approx(
        np.mean([h.n_feasible / FL["n_devices"] for h in hist]))


def test_fleet_policy_and_runtime_arguments(clients):
    base = _port_server(clients)
    fleet = MaterializedFleet(base.devices,
                              full_model_bytes=base.fleet.full_model_bytes)
    policy = OortPolicy(epsilon=0.5)
    runtime = SequentialRuntime(base.adapter, base.optimizer, base.hp,
                                torch.device("cpu"))
    srv = _port_server(clients, fleet=fleet, selection_policy=policy,
                       runtime=runtime)
    assert srv.fleet is fleet and srv.selector is policy
    assert srv.runtime is runtime
    # the materialized view of the streaming fleet picks the same cohorts
    a, b = base.run_round(0), srv.run_round(0)
    assert (a.n_feasible, a.n_selected) == (b.n_feasible, b.n_selected)
    vec = _port_server(clients, runtime="vectorized")
    assert vec.runtime.name == "vectorized"
    # the sharded runtime is ported: one process is a one-rank mesh
    sharded = _port_server(clients, runtime="sharded")
    assert sharded.runtime.name == "sharded"
    assert sharded.mesh.shape == {"data": 1, "model": 1}
    asy = _port_server(clients, runtime="async")
    assert isinstance(asy.runtime, AsyncBufferedRuntime)
    assert asy.runtime.client_speeds is asy.fleet
    assert isinstance(_port_server(clients, fl={"selection": "tifl"})
                      .selector, TiFLPolicy)


@pytest.fixture
def shrunk_reference(monkeypatch, tmp_path):
    """The reference's table modules at 8x8 and width 0.125, writing under
    ``tmp_path``."""
    monkeypatch.setattr(r_bcommon, "RESULTS_DIR", str(tmp_path))
    for mod in (r_table1, r_table2):
        setup = mod.make_fl_setup
        cfg = mod.CNNConfig
        monkeypatch.setattr(mod, "make_fl_setup",
                            lambda seed, _s=setup: _s(seed, image_size=8))
        monkeypatch.setattr(
            mod, "CNNConfig", lambda _c=cfg, **kw: dataclasses.replace(
                _c(**kw), image_size=8, width_mult=0.125))


TINY_METHODS = ("fedavg", "exclusivefl", "depthfl")


def test_table1_participation_matches_reference(shrunk_reference, tmp_path):
    ref = r_table1.run(rounds=2, archs=("resnet18",), methods=TINY_METHODS,
                       quiet=True)
    port = table1_accuracy.run(rounds=2, archs=("resnet18",),
                               methods=TINY_METHODS, width=0.125,
                               image_size=8, quiet=True, device="cpu",
                               out_path=tmp_path / "t1.json")
    assert ref.keys() == port.keys()
    for key in ref:
        assert port[key]["pr"] == ref[key]["pr"], key
        assert 0.0 <= port[key]["acc"] <= 1.0
    # the exclusive method keeps a fraction, NeuLite and FedAvg more
    assert port[("resnet18", "exclusivefl")]["pr"] < port[(
        "resnet18", "neulite")]["pr"] <= port[("resnet18", "fedavg")]["pr"]
    assert (tmp_path / "t1.json").exists()


def test_table2_feasibility_matches_reference(shrunk_reference, tmp_path):
    ref = r_table2.run(rounds=2, quiet=True)
    port = table2_complexity.run(rounds=2, width=0.125, image_size=8,
                                 quiet=True, device="cpu",
                                 out_path=tmp_path / "t2.json")
    for arch in ("resnet18", "resnet34"):
        for key in ("neulite_pr", "full_model_feasible_devices"):
            assert port[arch][key] == ref[arch][key], (arch, key)
    # ResNet34 on ResNet18's budgets: no device fits the full model, yet
    # NeuLite's stages still train
    assert port["resnet34"]["full_model_feasible_devices"] == 0
    assert port["resnet34"]["neulite_pr"] > 0


def test_fig7_rows_on_cpu(tmp_path):
    out = fig7_time.run(archs=("resnet18",), batch=4, sizes=((0.125, 8),),
                        quiet=True, device="cpu",
                        out_path=tmp_path / "f7.json")
    assert list(out) == [fig7_time.size_label(0.125, 8)]
    row = out[fig7_time.size_label(0.125, 8)]["resnet18"]
    eager = row["eager"]
    assert len(eager["stage_ms"]) == len(eager["speedups"]) == 4
    assert eager["full_ms"] > 0 and all(s > 0 for s in eager["stage_ms"])
    assert eager["speedups"] == pytest.approx(
        [eager["full_ms"] / s for s in eager["stage_ms"]])
    assert row["captured"].startswith("not measured")
    import json
    doc = json.loads((tmp_path / "f7.json").read_text())
    assert doc["meta"]["device"] == "cpu" and doc["meta"]["clock"] == "host"
