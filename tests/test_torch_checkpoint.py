"""Crash safety in the port: the checkpoint store and the server's
``save_state`` / ``load_state`` / ``restore``, held against the JAX
reference's files and servers.

The store's tests are the reference's (``tests/test_optim_checkpoint_data.py``)
run on the port; then the bytes across the packages both ways, bf16
included.  The server resumes at ``tests/test_runtime.py``'s sizes (ResNet18
at width 0.125, 8x8, 4 clients, 3 a round, 2 stages; a fleet whose every
device fits both stages, so that every round trains): 2 rounds, save,
restore, 2 rounds must equal 4 straight rounds bit for bit on the CPU.  A
reference checkpoint restores in the port to exactly ``from_reference`` of
its params, with its history, RNG, schedule and selector state, and a port
checkpoint in the reference to exactly ``to_reference`` of the port's; two
rounds of each package from the cross-loaded state then agree at 1e-3 of
the largest update.  One module-scoped reference server serves every
reference side (``load_state`` into it reuses its compiles).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as r_load
from repro.checkpoint import save_checkpoint as r_save
from repro.common.tree import map_with_path as r_map_with_path
from repro.core import make_adapter as r_make_adapter
from repro.data import Batcher as RBatcher
from repro.data import dirichlet_partition, make_image_dataset
from repro.federated.devices import Fleet as RFleet
from repro.federated.server import FLConfig as RFLConfig
from repro.federated.server import NeuLiteServer as RServer
from repro.models.cnn import CNNConfig as RConfig
from repro_torch import bridge
from repro_torch.checkpoint import (checkpoint_step, latest_checkpoint,
                                    load_checkpoint, read_checkpoint_meta,
                                    save_checkpoint)
from repro_torch.common.tree import flatten_paths, map_with_path, tree_leaves
from repro_torch.core.progressive import make_adapter as t_make_adapter
from repro_torch.data.loader import Batcher
from repro_torch.federated.devices import Fleet
from repro_torch.federated.server import FLConfig, NeuLiteServer, RoundResult
from repro_torch.models.cnn import CNNConfig

TOL = 1e-3
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    """A tensor's raw bits as a numpy integer array."""
    t = t.detach().cpu().contiguous()
    width = t.element_size()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[width]).numpy()


# --------------------------------------------------------------------------- #
# the store (the reference's store tests, run on the port)
# --------------------------------------------------------------------------- #
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "b": [torch.ones(2), torch.zeros(3)], "skip": None}
    p = save_checkpoint(str(tmp_path), 7, tree, meta={"round": 7})
    assert latest_checkpoint(str(tmp_path)) == p
    assert read_checkpoint_meta(p) == {"round": 7}
    loaded, meta = load_checkpoint(p, tree, device="cpu")
    assert meta == {"round": 7} and loaded["skip"] is None
    assert isinstance(loaded["b"], list)
    for a, b in zip(tree_leaves(tree), tree_leaves(loaded), strict=True):
        assert b.device == CPU and b.dtype == a.dtype
        assert torch.equal(a, b)


def test_checkpoint_rotation(tmp_path):
    for s in range(6):
        save_checkpoint(str(tmp_path), s, {"w": torch.zeros(2)}, keep=3)
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert files == [f"ckpt_{s:08d}.npz" for s in (3, 4, 5)]
    assert len(os.listdir(tmp_path)) == 6          # each with its sidecar


def test_checkpoint_rotation_rejects_nonpositive_keep(tmp_path):
    for keep in (0, -1):
        with pytest.raises(ValueError, match="keep"):
            save_checkpoint(str(tmp_path), 0, {"w": torch.zeros(2)},
                            keep=keep)
    assert os.listdir(tmp_path) == []


def test_checkpoint_extension_dtypes_roundtrip_bitexact(tmp_path):
    """bf16 (and float8) leaves go to disk as their raw unsigned view and
    come back with their dtype and every bit; f16, f32 as they are."""
    g = torch.Generator().manual_seed(0)
    tree = {"bf16": (torch.randn(2, 3, generator=g) / 7).bfloat16(),
            "f16": torch.arange(5, dtype=torch.float16) / 3,
            "f32": torch.randn(3, generator=g),
            "f8": torch.randn(4, generator=g).to(torch.float8_e4m3fn)}
    p = save_checkpoint(str(tmp_path), 0, tree)
    with np.load(p) as data:
        assert data["bf16"].dtype == np.uint16
        assert data["f8"].dtype == np.uint8
    sidecar = json.loads(open(p + ".json").read())
    assert sidecar["__store__"] == {"version": 1, "dtypes": {
        "bf16": "bfloat16", "f8": "float8_e4m3fn"}}
    loaded, _ = load_checkpoint(p, tree, device="cpu")
    for k in tree:
        assert loaded[k].dtype == tree[k].dtype, k
        np.testing.assert_array_equal(_bits(loaded[k]), _bits(tree[k]))


def test_checkpoint_64bit_leaves_survive(tmp_path):
    tree = {"i": np.asarray([2 ** 60 + 1, -5], np.int64),
            "f": torch.tensor([1e308, 1.0 + 2 ** -50], dtype=torch.float64)}
    p = save_checkpoint(str(tmp_path), 0, tree)
    loaded, _ = load_checkpoint(p, tree, device="cpu")
    assert loaded["i"].dtype == torch.int64
    assert loaded["f"].dtype == torch.float64
    np.testing.assert_array_equal(loaded["i"].numpy(), tree["i"])
    assert torch.equal(loaded["f"], tree["f"])


def test_truncated_checkpoint_never_loads_as_valid(tmp_path):
    tree = {"w": torch.arange(128, dtype=torch.float32)}
    p0 = save_checkpoint(str(tmp_path), 0, tree)
    p1 = save_checkpoint(str(tmp_path), 1, tree)
    with open(p1, "r+b") as f:          # tear the newest file in half
        f.truncate(os.path.getsize(p1) // 2)
    assert latest_checkpoint(str(tmp_path)) == p0
    with pytest.raises(ValueError, match="corrupt or truncated"):
        load_checkpoint(p1, tree, device="cpu")
    with open(p1, "wb"):                # zero bytes: still skipped cleanly
        pass
    assert latest_checkpoint(str(tmp_path)) == p0
    assert latest_checkpoint(str(tmp_path / "absent")) is None


def test_save_checkpoint_leaves_no_temp_droppings(tmp_path):
    save_checkpoint(str(tmp_path), 3, {"w": torch.zeros(2)})
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000003.npz",
                                            "ckpt_00000003.npz.json"]


def test_load_checkpoint_names_structure_mismatch(tmp_path):
    p = save_checkpoint(str(tmp_path), 0, {"a": torch.zeros(2),
                                           "b": torch.ones(3)})
    with pytest.raises(ValueError) as ei:
        load_checkpoint(p, {"a": torch.zeros(2), "c": torch.ones(3)},
                        device="cpu")
    assert "missing leaf paths ['c']" in str(ei.value)
    assert "unexpected leaf paths ['b']" in str(ei.value)


def test_unrepresentable_sidecar_dtype_raises(tmp_path):
    p = save_checkpoint(str(tmp_path), 0, {"w": torch.zeros(2).bfloat16()})
    doc = json.loads(open(p + ".json").read())
    doc["__store__"]["dtypes"]["w"] = "float4_e2m1fn"
    with open(p + ".json", "w") as f:
        json.dump(doc, f)
    with pytest.raises(ValueError, match="cannot represent.*float4_e2m1fn"):
        load_checkpoint(p, {"w": torch.zeros(2)}, device="cpu")


def test_latest_checkpoint_orders_numerically_past_1e8(tmp_path):
    tree = {"w": torch.zeros(2)}
    save_checkpoint(str(tmp_path), 99_999_999, tree)
    p_big = save_checkpoint(str(tmp_path), 100_000_000, tree)
    assert latest_checkpoint(str(tmp_path)) == p_big
    assert checkpoint_step(p_big) == 100_000_000
    with pytest.raises(ValueError, match="not a checkpoint path"):
        checkpoint_step(str(tmp_path / "ckpt_x.npz"))
    # rotation drops the numerically oldest, not the lexically oldest
    save_checkpoint(str(tmp_path), 100_000_001, tree, keep=2)
    steps = sorted(checkpoint_step(os.path.join(str(tmp_path), f))
                   for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert steps == [100_000_000, 100_000_001]


def test_paths_are_the_references():
    """A leaf's path is the reference's ``path_str``; None has none."""
    tree = {"model": {"units": [{"conv1": {"w": 1, "b": 2}}, {"x": 3}],
                      "head": {"w": 4}},
            "surrogates": None, "projector": [{"w": 5}, None, {"w": 6}],
            "z": ({"k": 7},)}
    mine, ref = [], []
    map_with_path(lambda p, x: mine.append((p, x)), tree)
    r_map_with_path(lambda p, x: ref.append((p, x)), tree)
    assert mine == ref
    assert "model/units/0/conv1/w" in flatten_paths(tree)
    assert map_with_path(lambda p, x: p, tree)["surrogates"] is None


def test_load_checkpoint_defaults_to_the_card(tmp_path, monkeypatch):
    p = save_checkpoint(str(tmp_path), 0, {"w": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_checkpoint(p, {"w": torch.zeros(2)})


# --------------------------------------------------------------------------- #
# bytes across the packages
# --------------------------------------------------------------------------- #
def _mixed_tree():
    g = np.random.default_rng(0)
    return {"conv": {"w": g.standard_normal((3, 3, 2, 4)).astype(np.float32)},
            "bf": [g.standard_normal((5,)).astype(np.float32)],
            "i": np.asarray([2 ** 40, -3], np.int64)}


def test_reference_files_load_in_port(tmp_path):
    ref_tree = _mixed_tree()      # the int64 leaf stays numpy (x64 is off)
    ref_tree["conv"]["w"] = jnp.asarray(ref_tree["conv"]["w"])
    ref_tree["bf"][0] = jnp.asarray(ref_tree["bf"][0], jnp.bfloat16)
    p = r_save(str(tmp_path), 5, ref_tree, meta={"by": "reference"})
    like = {"conv": {"w": 0}, "bf": [0], "i": 0}
    got, meta = load_checkpoint(p, like, device="cpu")
    assert meta == {"by": "reference"}
    assert got["bf"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _bits(got["bf"][0]),
        np.asarray(ref_tree["bf"][0]).view(np.int16))
    np.testing.assert_array_equal(got["conv"]["w"].numpy(),
                                  np.asarray(ref_tree["conv"]["w"]))
    assert got["i"].dtype == torch.int64
    np.testing.assert_array_equal(got["i"].numpy(), _mixed_tree()["i"])


def test_port_files_load_in_reference(tmp_path):
    tree = jax.tree.map(torch.from_numpy, _mixed_tree())
    tree["bf"][0] = tree["bf"][0].bfloat16()
    p = save_checkpoint(str(tmp_path), 5, tree, meta={"by": "port"})
    like = jax.tree.map(np.asarray, _mixed_tree())
    got, meta = r_load(p, like)
    assert meta == {"by": "port"}
    assert str(got["bf"][0].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(got["bf"][0]).view(np.int16),
                                  _bits(tree["bf"][0]))
    np.testing.assert_array_equal(np.asarray(got["conv"]["w"]),
                                  tree["conv"]["w"].numpy())
    np.testing.assert_array_equal(np.asarray(got["i"]), _mixed_tree()["i"])


# --------------------------------------------------------------------------- #
# resume within the port (tests/test_runtime.py's sizes)
# --------------------------------------------------------------------------- #
FL = dict(n_devices=4, clients_per_round=3, local_epochs=1, batch_size=16,
          num_stages=2, seed=0)
# budgets of a fleet for a model of 16 MB: every device fits either stage,
# so every round trains 3 clients (the default fleet fits one at stage 0
# and none at stage 1)
FLEET = (0, 4, 16_000_000)
T_CFG = CNNConfig(name="r18", arch="resnet18", num_classes=4, image_size=8,
                  width_mult=0.125)


@pytest.fixture(scope="module")
def data():
    ds = make_image_dataset(0, 160, num_classes=4, image_size=8)
    parts = dirichlet_partition(0, ds.labels, 4, alpha=1.0)
    return ([ds.subset(p) for p in parts],
            make_image_dataset(3, 64, num_classes=4, image_size=8))


def _port_server(data, params=None, **kw):
    clients, test = data
    flc = FLConfig(**FL, use_hsic_kernel=True, **kw)
    return NeuLiteServer(t_make_adapter(T_CFG, flc.num_stages), clients, flc,
                         test_batcher=Batcher(test, 32, seed=7,
                                              kind="image"),
                         fleet=Fleet(*FLEET), params=params, device="cpu")


def _port_restore(data, path, flc, **kw):
    clients, test = data
    return NeuLiteServer.restore(
        t_make_adapter(T_CFG, flc.num_stages), clients, flc, str(path),
        test_batcher=Batcher(test, 32, seed=7, kind="image"),
        fleet=Fleet(*FLEET), device="cpu", **kw)


def _assert_history_equal(ref, res):
    assert len(ref) == len(res)
    for ha, hb in zip(ref, res):
        da, db = dataclasses.asdict(ha), dataclasses.asdict(hb)
        assert da.keys() == db.keys()
        for k, va in da.items():
            vb = db[k]
            if isinstance(va, float) and np.isnan(va):
                assert np.isnan(vb), (k, ha, hb)
            else:
                assert va == vb, (k, ha, hb)


def _assert_same_params(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


RESUME_CASES = {"sequential": dict(runtime="sequential"),
                "vectorized": dict(runtime="vectorized"),
                "plateau": dict(runtime="sequential", schedule="plateau"),
                "tifl": dict(runtime="sequential", selection="tifl"),
                "oort": dict(runtime="sequential", selection="oort")}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_matches_straight_run_exactly(case, data, tmp_path):
    kw = RESUME_CASES[case]
    straight = _port_server(data, **kw)
    straight.run(4)

    srv = _port_server(data, **kw)
    srv.run(2)
    path = srv.save_state(str(tmp_path))
    assert os.path.basename(path) == "ckpt_00000002.npz"
    res = _port_restore(data, tmp_path, srv.flc)
    assert res.next_round == 2
    res.run(2)

    assert all(h.n_selected > 0 for h in straight.history[2:])
    _assert_same_params(straight.params, res.params)
    _assert_history_equal(straight.history, res.history)
    assert straight.rng.bit_generator.state == res.rng.bit_generator.state
    assert straight.schedule.state_dict() == res.schedule.state_dict()
    assert straight.selector.state_dict() == res.selector.state_dict()
    for a, b in zip(straight.batchers, res.batchers, strict=True):
        assert a.rng.bit_generator.state == b.rng.bit_generator.state
    # the evaluation's accuracy does not see the test batches' order, so
    # the test batcher's RNG is held by its state
    assert (straight.test_batcher.rng.bit_generator.state
            == res.test_batcher.rng.bit_generator.state)
    if case in ("tifl", "oort"):
        assert res.selector.state_dict() != {}


def test_run_checkpoints_every_n_rounds(data, tmp_path):
    srv = _port_server(data, checkpoint_dir=str(tmp_path),
                       checkpoint_every=2, keep_checkpoints=1)
    srv.run(3)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000002.npz",
                                            "ckpt_00000002.npz.json"]
    srv.run(1)
    latest = latest_checkpoint(str(tmp_path))
    assert checkpoint_step(latest) == 4
    meta = read_checkpoint_meta(latest)
    assert meta["next_round"] == 4 and len(meta["history"]) == 4
    assert meta["async"] is None and meta["runtime"] == "sequential"
    assert (meta["schedule_kind"], meta["selector_kind"]) == (
        "RoundRobinSchedule", "RandomPolicy")
    assert all(h["server_version"] is None for h in meta["history"])


def test_restore_rejects_config_mismatch(data, tmp_path):
    srv = _port_server(data, runtime="vectorized")
    srv.run(1)
    srv.save_state(str(tmp_path))
    with pytest.raises(ValueError, match="mismatch on runtime"):
        _port_restore(data, tmp_path, dataclasses.replace(
            srv.flc, runtime="sequential"))
    with pytest.raises(ValueError, match="mismatch on selector_kind"):
        _port_restore(data, tmp_path, dataclasses.replace(
            srv.flc, selection="oort"))
    with pytest.raises(ValueError, match="mismatch on schedule_kind"):
        _port_restore(data, tmp_path, dataclasses.replace(
            srv.flc, schedule="plateau"))
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        _port_restore(data, tmp_path / "empty", srv.flc)


def test_restore_rejects_plain_param_checkpoint(data, tmp_path):
    srv = _port_server(data)
    save_checkpoint(str(tmp_path), 0, srv.params, meta={"arch": "r18"})
    with pytest.raises(ValueError, match="not a NeuLiteServer state"):
        _port_restore(data, tmp_path, srv.flc)


def test_restore_rejects_an_async_buffer(data, tmp_path):
    """A server whose runtime keeps no buffer refuses a checkpoint that
    holds one."""
    srv = _port_server(data)
    path = srv.save_state(str(tmp_path))
    doc = json.loads(open(path + ".json").read())
    doc["meta"]["async"] = {"version": 3, "entries": []}
    with open(path + ".json", "w") as f:
        json.dump(doc, f)
    with pytest.raises(ValueError, match="async runtime's buffer.*"
                                         "sequential runtime has no buffer"):
        _port_restore(data, path, srv.flc)


# --------------------------------------------------------------------------- #
# across the packages
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def reference(data, tmp_path_factory):
    """The reference server after 2 rounds, its ``save_state`` directory
    and what it held there."""
    clients, test = data
    flc = RFLConfig(**FL, runtime="sequential")
    adapter = r_make_adapter(RConfig(name="r18", arch="resnet18",
                                     num_classes=4, image_size=8,
                                     width_mult=0.125), flc.num_stages)
    ref = RServer(adapter, clients, flc,
                  test_batcher=RBatcher(test, 32, seed=7, kind="image"),
                  fleet=RFleet(*FLEET))
    start = jax.device_get(ref.params)
    ref.run(2)
    d = str(tmp_path_factory.mktemp("ref_state"))
    path = ref.save_state(d)
    return ref, path, start


def _ref_params(ref):
    return jax.device_get(ref.params)


def _numpy_equal(a, b):
    la, da = jax.tree.flatten(a)
    lb, db = jax.tree.flatten(b)
    assert da == db
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _assert_same_loop_state(ref, port):
    assert ref.rng.bit_generator.state == port.rng.bit_generator.state
    assert ref.schedule.state_dict() == port.schedule.state_dict()
    assert ref.selector.state_dict() == port.selector.state_dict()
    assert ref.next_round == port.next_round
    for a, b in zip(ref.batchers, port.batchers, strict=True):
        assert a.rng.bit_generator.state == b.rng.bit_generator.state
    assert (ref.test_batcher.rng.bit_generator.state
            == port.test_batcher.rng.bit_generator.state)
    _assert_history_equal(ref.history, port.history)


def _update_rel_err(ref_new, start, port_new):
    r_new = [np.asarray(a, np.float64) for a in jax.tree.leaves(ref_new)]
    s = [np.asarray(a, np.float64) for a in jax.tree.leaves(start)]
    t_new = [np.asarray(a, np.float64) for a in
             jax.tree.leaves(bridge.to_reference(port_new))]
    r_upd = [a - b for a, b in zip(r_new, s)]
    t_upd = [a - b for a, b in zip(t_new, s)]
    scale = max(np.abs(u).max() for u in r_upd)
    assert scale > 0
    return max(float(np.abs(a - b).max())
               for a, b in zip(r_upd, t_upd, strict=True)) / scale


def test_reference_state_restores_in_port_exactly(reference, data):
    ref, path, _ = reference
    ref.load_state(path)
    port = _port_restore(data, path, FLConfig(**FL, use_hsic_kernel=True))
    want = bridge.from_reference(_ref_params(ref), "cpu")
    _assert_same_params(want, port.params)
    _numpy_equal(_ref_params(ref), bridge.to_reference(port.params))
    _assert_same_loop_state(ref, port)
    assert all(isinstance(h, RoundResult) for h in port.history)


def test_port_state_restores_in_reference_exactly(reference, data,
                                                  tmp_path):
    ref, _, start = reference
    port = _port_server(data, params=bridge.from_reference(start, "cpu"))
    port.run(2)
    path = port.save_state(str(tmp_path))
    ref.load_state(path)
    _numpy_equal(bridge.to_reference(port.params), _ref_params(ref))
    _assert_same_loop_state(ref, port)


@pytest.mark.parametrize("written_by", ["reference", "port"])
def test_cross_loaded_rounds_agree(written_by, reference, data, tmp_path):
    """Two more rounds of each package from one cross-loaded state: the
    same cohorts, feasibility and upload bytes, losses and the params'
    update within 1e-3 (of the loss, of the largest update)."""
    ref, ref_path, start = reference
    if written_by == "reference":
        path = ref_path
    else:
        port = _port_server(data, params=bridge.from_reference(start, "cpu"))
        port.run(2)
        path = port.save_state(str(tmp_path))
    ref.load_state(path)
    port = _port_restore(data, path, FLConfig(**FL, use_hsic_kernel=True))
    at = _ref_params(ref)
    ref.run(2)
    port.run(2)
    for rh, th in zip(ref.history[2:], port.history[2:], strict=True):
        assert (rh.stage, rh.n_selected, rh.n_feasible, rh.upload_bytes) \
            == (th.stage, th.n_selected, th.n_feasible, th.upload_bytes)
        assert rh.n_selected > 0
        assert abs(th.mean_loss - rh.mean_loss) <= TOL * abs(rh.mean_loss)
    assert ref.rng.bit_generator.state == port.rng.bit_generator.state
    assert _update_rel_err(_ref_params(ref), at, port.params) <= TOL
