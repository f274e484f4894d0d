"""The collective audit (``repro_torch.analysis.collectives``): the axes a
group of ranks crosses on a 2x2 (data, model) grid, the reference's rules
on synthetic records, and one audited ``ShardedRuntime`` round in a gloo
world of 4 ranks (data 2 x model 2) on the CPU, started once for the file
while the other tests run."""
import pytest
import torch

from repro_torch.analysis import collectives as col
from repro_torch.analysis.report import Report
from repro_torch.federated.runtime import ShardedRuntime
from repro_torch.launch.mesh import HostMesh, start_world

AXES = ("data", "model")
# HostMesh lays ranks out row-major over (data, model)
COORDS = {r: {"data": r // 2, "model": r % 2} for r in range(4)}


@pytest.fixture(scope="module", autouse=True)
def world():
    """One audited round in a world of 4, started before the first test;
    joined by the test that reads it."""
    from repro_torch.analysis.harness import audited_mesh_round
    return start_world(audited_mesh_round, 4, "cpu", "sharded", 2, "tx",
                       threads=1)


def _rec(kind, ranks, phase="aggregation"):
    return col.CollectiveRecord(kind=kind, ranks=tuple(ranks), nbytes=4,
                                location="runtime.py:1", phase=phase)


def _audit(records, kind="round", n_agg_leaves=3, rounds=1):
    report = Report()
    summary = col.audit_collectives(records, report, program="p",
                                    coords=COORDS, axis_names=AXES,
                                    kind=kind, n_agg_leaves=n_agg_leaves,
                                    rounds=rounds)
    return report, summary


def test_crossed_axes_on_a_2x2_grid():
    assert col.crossed_axes([0, 1], COORDS, AXES) == ("model",)
    assert col.crossed_axes([2, 3], COORDS, AXES) == ("model",)
    assert col.crossed_axes([0, 2], COORDS, AXES) == ("data",)
    assert col.crossed_axes([1, 3], COORDS, AXES) == ("data",)
    assert col.crossed_axes([0, 1, 2, 3], COORDS, AXES) == AXES
    assert col.crossed_axes([3], COORDS, AXES) == ()


def test_a_gratuitous_data_axis_gather_is_caught():
    report, summary = _audit([_rec("all_reduce", [0, 2]),
                              _rec("all_gather", [0, 2])])
    assert sorted(f.check for f in report.errors) == [
        "collectives.data-axis-gather", "collectives.seam-non-allreduce"]
    assert summary["by_kind"] == {"all_reduce[data]": 1,
                                  "all_gather[data]": 1}


def test_model_axis_gathers_are_legal_anywhere():
    report, summary = _audit(
        [_rec("all_gather", [0, 1], "local"),
         _rec("all_reduce", [0, 2]),
         _rec("all_gather", [2, 3], "aggregation")])
    assert report.ok() and not report.findings
    assert summary["data_axis_all_reduces"] == 1


def test_a_data_all_reduce_in_local_training_is_caught():
    report, _ = _audit([_rec("all_reduce", [0, 2], "local"),
                        _rec("all_reduce", [0, 2])])
    assert [f.check for f in report.errors] == [
        "collectives.local-data-crossing"]
    report, _ = _audit([_rec("all_reduce", [1, 3])], kind="local")
    assert [f.check for f in report.errors] == [
        "collectives.local-data-crossing"]


def test_the_seam_count_is_bounded():
    ok = [_rec("all_reduce", [0, 2]) for _ in range(5)]     # 3 leaves + 2
    assert _audit(ok)[0].ok()
    report, summary = _audit(ok + [_rec("all_reduce", [0, 2])])
    assert [f.check for f in report.errors] == [
        "collectives.eq1-allreduce-count"]
    assert summary["data_axis_all_reduces"] == 6
    report, _ = _audit([_rec("all_gather", [0, 1])])         # none over data
    assert [f.check for f in report.errors] == [
        "collectives.eq1-allreduce-count"]
    # over two rounds the bounds double
    assert _audit(ok + ok, rounds=2)[0].ok()


def test_the_consensus_gather_is_counted_and_bounded():
    gather = _rec("all_gather", range(4), "consensus")
    report, summary = _audit([gather, _rec("all_reduce", [0, 2])])
    assert report.ok() and summary["consensus_gathers"] == 1
    report, _ = _audit([gather, gather, _rec("all_reduce", [0, 2])])
    assert [f.check for f in report.errors] == ["collectives.host-consensus"]


def test_a_clean_seam_passes():
    report, summary = _audit([_rec("all_reduce", [0, 2]),
                              _rec("all_reduce", [1, 3]),
                              _rec("all_gather", [0, 1])],
                             kind="aggregation")
    assert report.ok() and not report.findings
    assert summary["n_collectives"] == 3


def test_the_phase_seams_exist():
    """The runtime methods the recorder reads phases from are real."""
    for name in col.PHASES:
        assert hasattr(ShardedRuntime, name) or hasattr(HostMesh, name), name


def test_one_audited_sharded_round_in_a_world_of_4(world):
    results = world.join()
    assert len(results) == 4
    for res in results:
        assert res["ok"], res["findings"]
        arts = res["artifacts"]
        assert arts["mesh"] == {"data": 2, "model": 2}
        summary = arts["collectives"]
        assert summary["consensus_gathers"] == 1
        assert 1 <= summary["data_axis_all_reduces"]
        assert arts["trainable_ratio"] <= 0.55
        # every data-crossing collective is an all-reduce or the consensus
        assert all(k.startswith("all_reduce") or "model" in k
                   or k == "all_gather[data,model]"
                   for k in summary["by_kind"] if "data" in k)
    assert torch.distributed.is_available()
