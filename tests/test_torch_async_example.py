"""The port's ``examples/async_fedbuff.py`` and ``fl_round_throughput``'s
async and population modes on the CPU, at a shrunk size (the example's
ResNet18 on 480 images, not 1200; the benchmark at 4 cohorts and a
few rounds): the example's two legs and its kill-and-resume harness (a
run killed as round 3 opens, resumed from its round-2 checkpoint, equal
to the bit to an uninterrupted run: params, server version, pending
buffer and history), the benchmark's rows and their bookkeeping."""
import json

import pytest
import torch

from repro_torch.benchmarks import fl_round_throughput as flr
from repro_torch.checkpoint import latest_checkpoint, read_checkpoint_meta
from repro_torch.examples import async_fedbuff as ex


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(ex, "N_TRAIN", 480)
    monkeypatch.setattr(ex, "N_TEST", 64)


def test_example_legs(small, capsys):
    res = ex.main("cpu", rounds=3)
    out = capsys.readouterr().out
    assert "== synchronous (vectorized) ==" in out
    assert "== async x sharded (model_parallel=2, a world of 4) ==" in out
    leg = res["mesh_leg"]
    assert leg["mesh"] == {"data": 2, "model": 2}
    assert 0.0 <= leg["acc"] <= 1.0 and leg["server_version"] > 0
    hist = res["history"]
    assert len(hist) == 3 and all(h.server_version is not None
                                  for h in hist)
    assert [h.server_version for h in hist] == sorted(
        h.server_version for h in hist)
    assert res["server_version"] == hist[-1].server_version
    # an async round lasts from its open to its last flush: never longer
    # than the synchronous barrier on the same cohorts
    assert 0 < res["async_time"] <= res["sync_time"]
    assert res["speedup"] == pytest.approx(
        res["sync_time"] / res["async_time"])
    assert 0.0 <= res["async_acc"] <= 1.0


class _Killed(Exception):
    pass


def _kill():
    raise _Killed


def test_example_kill_and_resume_is_exact(small, tmp_path):
    straight, killed = str(tmp_path / "straight"), str(tmp_path / "killed")
    ex.checkpointed_run(straight, 4, device="cpu")
    with pytest.raises(_Killed):
        ex.checkpointed_run(killed, 4, kill_at=3, device="cpu",
                            on_kill=_kill)
    # the resume starts from a non-empty buffer
    meta = read_checkpoint_meta(latest_checkpoint(killed))
    assert meta["next_round"] == 2 and meta["async"]["stages"]
    resumed = ex.checkpointed_run(killed, 4, resume=True, compare=straight,
                                  device="cpu")
    assert resumed.next_round == 4 and len(resumed.runtime.state)


def test_same_run_sees_a_changed_buffer(small, tmp_path):
    a = ex.checkpointed_run(str(tmp_path / "a"), 2, device="cpu")
    b = ex.checkpointed_run(str(tmp_path / "b"), 2, device="cpu")
    assert all(ex.same_run(a, b).values()) and len(b.runtime.state)
    b.runtime.state.entries[0].weight += 1.0
    assert not ex.same_run(a, b)["buffer"]
    b.runtime.state.version += 1
    assert not ex.same_run(a, b)["version"]


def test_async_mode_rows(tmp_path):
    out = tmp_path / "bench.json"
    cpu = flr.device_meta(torch.device("cpu"))
    out.write_text(json.dumps({"meta": {**cpu, "iters": 2},
                               "rows": [{"earlier": 1}]}))
    rows = flr.run_async("cpu", str(out), settings=[("cnn", 4, 4, 2)],
                         rounds=3)
    (row,) = rows
    assert row["buffer_size"] == 3 and row["rounds"] == 3
    # every delivery flushed once or still pending
    assert row["n_uploads"] + row["n_pending"] == 4 * 3
    assert row["server_version"] == row["n_uploads"] // 3
    assert row["n_carried"] >= 1 and row["speedup"] > 1.0
    assert row["trainable_bytes"] > 0 and len(row["round_seconds"]) == 3
    doc = json.loads(out.read_text())
    assert doc["rows"] == [{"earlier": 1}] and doc["async"] == rows
    assert doc["meta"] == {**cpu, "iters": 2}


def test_merge_starts_afresh_on_another_device(tmp_path):
    out = tmp_path / "bench.json"
    card = {**flr.device_meta(torch.device("cpu")), "device": "cuda"}
    out.write_text(json.dumps({"meta": {**card, "iters": 2},
                               "rows": [{"earlier": 1}]}))
    flr.merge_bench_json(str(out), {"async": [{"new": 1}]},
                         torch.device("cpu"))
    doc = json.loads(out.read_text())
    assert doc == {"meta": flr.device_meta(torch.device("cpu")),
                   "async": [{"new": 1}]}


def test_population_mode_rows(tmp_path):
    rows = flr.run_population("cpu", str(tmp_path / "pop.json"),
                              populations=(1e2, 1e6), rounds=1)
    assert [r["population"] for r in rows] == [100, 1_000_000]
    for r in rows:
        assert r["rounds_per_s"] > 0 and r["server_peak_mb"] > 0
    # opening a round is O(cohort): the heap a 10^6 population's server
    # and round take stays near a 10^2 one's
    assert rows[1]["server_peak_mb"] < 4 * rows[0]["server_peak_mb"]
    assert json.loads((tmp_path / "pop.json").read_text())[
        "population"] == rows
