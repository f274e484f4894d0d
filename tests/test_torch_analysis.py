"""The port's auditors on the CPU (``repro_torch.analysis``): the report
against the reference's, the transfer probe on planted reads and on the
real rounds of ``tx_setup`` and ``cnn_setup`` (their port counterparts),
the purity pass and the
state-release check on planted faults and on the real steps, every
contract rule on a planted violation and on the port's own tree, and
``run_audits`` of three backends."""
import inspect
import json

import numpy as np
import pytest
import torch

from repro.analysis.report import Report as RReport
from repro_torch.analysis import contracts
from repro_torch.analysis import donation as don
from repro_torch.analysis import hostsync as hs
from repro_torch.analysis.harness import run_audits
from repro_torch.analysis.report import Report
from repro_torch.common import device as tdevice
from repro_torch.core.curriculum import CurriculumHP
from repro_torch.core.progressive import make_adapter
from repro_torch.data.loader import Batcher, stack_round
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_image_dataset, make_lm_dataset
from repro_torch.federated.devices import DeviceProfile, MaterializedFleet
from repro_torch.federated.runtime import RoundProgramSpec, make_runtime
from repro_torch.federated.server import FLConfig, NeuLiteServer
from repro_torch.launch.mesh import HostMesh
from repro_torch.models.cnn import CNNConfig
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import sgd

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setups():
    """The port's counterparts of conftest's ``cnn_setup`` and ``tx_setup``:
    their configs, 2 stages and data (the port's byte-identical copies of
    the reference's generators), params from the port's init (no value is
    compared here)."""
    images = make_image_dataset(0, 200, num_classes=4, image_size=8)
    parts = dirichlet_partition(0, images.labels, 4, alpha=1.0)
    text = make_lm_dataset(0, 96, 8, 64)
    idx = np.arange(len(text))
    cnn = make_adapter(CNNConfig(name="r18", arch="resnet18", num_classes=4,
                                 image_size=8, width_mult=0.125), 2)
    tx = make_adapter(ModelConfig(name="t", family="dense", num_layers=4,
                                  d_model=32, num_heads=2, num_kv_heads=2,
                                  d_ff=64, vocab_size=64, dtype="float32"),
                      2)
    return {"cnn": (cnn, cnn.init_params(0, "cpu"),
                    [images.subset(p) for p in parts], 16, "image"),
            "tx": (tx, tx.init_params(0, "cpu"),
                   [text.subset(idx[i::3]) for i in range(3)], 8, "lm")}


def _batchers(datasets, bs, kind):
    return [Batcher(ds, bs, seed=i, kind=kind)
            for i, ds in enumerate(datasets)]


def _runtime(name, adapter):
    return make_runtime(name, adapter, sgd(0.05, 0.9, 5e-4),
                        CurriculumHP(mu=0.01), CPU)


# --------------------------------------------------------------------------- #
# the report
# --------------------------------------------------------------------------- #
def _fill(report):
    report.add("memory.stage-peak", "stage 1 over", program="p")
    report.add("collectives.data-axis-gather", "gather", program="q",
               location="runtime.py:10")
    report.add("hostsync.explicit-sync", "sync", severity="info")
    report.add("donation.must-alias", "held", severity="warning")
    return report


def test_waiver_downgrades_exact_check_and_family():
    r = _fill(Report(waive={"memory.stage-peak", "collectives"}))
    assert r.ok() and len(r.findings) == 4
    assert [f.waived for f in r.findings] == [True, True, False, False]
    r = _fill(Report(waive={"memory"}))
    assert not r.ok() and len(r.errors) == 1
    with pytest.raises(ValueError):
        Report().add("x", "y", severity="fatal")


def test_report_renders_and_dumps_as_the_reference(tmp_path):
    for waive in ((), ("memory",)):
        ours, theirs = _fill(Report(waive)), _fill(RReport(waive))
        ours.artifacts["t"] = theirs.artifacts["t"] = {"a": [1, 2]}
        for verbose in (False, True):
            assert ours.render(verbose=verbose) == theirs.render(
                verbose=verbose)
        assert ours.to_dict() == theirs.to_dict()
        path = tmp_path / "r.json"
        ours.dump_json(str(path))
        assert json.loads(path.read_text()) == theirs.to_dict()


# --------------------------------------------------------------------------- #
# the transfer probe
# --------------------------------------------------------------------------- #
class _Planted:
    name = "planted"

    def run_round(self, *_):
        t = torch.arange(4.0)
        a = float(t[0])
        b = t[1].item()
        c = t.numpy()
        d = np.asarray(t)
        tdevice.to_host(t)
        return a, b, c, d


def _line_of(fn, text):
    src, start = inspect.getsourcelines(fn)
    return start + next(i for i, s in enumerate(src) if text in s)


def test_probe_catches_planted_reads_at_their_lines():
    report = Report()
    hs.audit_runtime_round(_Planted(), None, 0, [], [], 1, report)
    msgs = [f.message for f in report.findings
            if f.check == "hostsync.hidden-transfer"]
    fn = _Planted.run_round
    for via, text in (("Tensor.__float__", "float(t[0])"),
                      ("Tensor.item", ".item()"),
                      ("Tensor.numpy", "t.numpy()"),
                      ("np.asarray", "np.asarray(t)")):
        where = f"test_torch_analysis.py:{_line_of(fn, text)}"
        assert any(f"via {via} @ {where}" in m for m in msgs), (via, msgs)
    assert len(msgs) == 4
    # to_host is sanctioned but counted: the runtime contract is zero
    assert [f.check for f in report.findings].count(
        "hostsync.excess-sync") == 1
    assert report.artifacts["hostsync"]["planted.run_round"]["to_host"] == 1


def test_probe_restores_every_patch():
    saved = [getattr(torch.Tensor, n) for n in
             hs.TENSOR_SEAMS + ("cpu", "to")]
    seams = (np.asarray, np.array, tdevice.to_host, HostMesh.gather_host)
    with hs.transfer_probe():
        assert torch.Tensor.item is not saved[0]
        assert tdevice.to_host is not seams[2]
    assert [getattr(torch.Tensor, n) for n in
            hs.TENSOR_SEAMS + ("cpu", "to")] == saved
    assert (np.asarray, np.array, tdevice.to_host,
            HostMesh.gather_host) == seams


@pytest.mark.parametrize("name", ["sequential", "vectorized"])
@pytest.mark.parametrize("kind", ["cnn", "tx"])
def test_real_runtime_rounds_read_nothing(setups, name, kind):
    adapter, params, datasets, bs, dkind = setups[kind]
    runtime = _runtime(name, adapter)
    report = Report()
    hs.audit_runtime_round(runtime, params, 1, _batchers(datasets, bs, dkind),
                           [0, 1], 1, report)
    assert report.ok() and not report.findings, report.render()
    assert report.artifacts["hostsync"][f"{name}.run_round"] == {
        "unsanctioned": 0, "to_host": 0, "consensus": 0,
        "implicit_syncs": 0, "explicit_syncs": 0}


def _server(adapter, params, datasets, bs, dkind, **kw):
    """A server over a fleet where every device fits every stage."""
    flc = FLConfig(n_devices=len(datasets), clients_per_round=2,
                   local_epochs=1, batch_size=bs, num_stages=2, seed=0)
    fleet = MaterializedFleet([DeviceProfile(i, 1 << 40, 1.0)
                               for i in range(len(datasets))])
    return NeuLiteServer(adapter, datasets, flc, data_kind=dkind,
                         params=params, device="cpu", fleet=fleet, **kw)


@pytest.mark.parametrize("kind", ["cnn", "tx"])
def test_server_round_and_evaluation_read_once_each(setups, kind):
    adapter, params, datasets, bs, dkind = setups[kind]
    server = _server(adapter, params, datasets, bs, dkind,
                     test_batcher=Batcher(datasets[0], bs, seed=9,
                                          kind=dkind))
    report = Report()
    hs.audit_server_round(server, report)
    assert report.ok() and not report.findings, report.render()
    arts = report.artifacts["hostsync"]
    assert arts["NeuLiteServer.run_round"]["to_host"] == 1
    assert arts["NeuLiteServer.evaluate"]["to_host"] == 1
    assert server.history[-1].n_selected == 2


def test_a_server_reading_twice_is_caught(setups, monkeypatch):
    adapter, params, datasets, bs, dkind = setups["cnn"]
    server = _server(adapter, params, datasets, bs, dkind)
    run_round = server.runtime.run_round

    def reads(*a, **kw):
        out = run_round(*a, **kw)
        tdevice.to_host(out.mean_loss)     # a second read of the round
        return out

    monkeypatch.setattr(server.runtime, "run_round", reads)
    report = Report()
    hs.audit_server_round(server, report)
    assert [f.check for f in report.errors] == ["hostsync.excess-sync"]


# --------------------------------------------------------------------------- #
# the purity pass and the state-release check
# --------------------------------------------------------------------------- #
def _promotes(x):
    y = x.double() * 2
    return y.sum().item()


def test_purity_flags_f64_and_host_reads_with_location():
    report = Report()
    hs.purity_findings(RoundProgramSpec("planted", "b", "step", _promotes,
                                        (torch.ones(3),)), report)
    f64 = [f for f in report.findings
           if f.check == "hostsync.f64-promotion"]
    reads = [f for f in report.findings if f.check == "hostsync.callback"]
    here = "test_torch_analysis.py"
    assert f64 and all(f.location.startswith(here) for f in f64)
    assert {f.location for f in f64} == {
        f"{here}:{_line_of(_promotes, 'double()')}",
        f"{here}:{_line_of(_promotes, '.item()')}"}
    assert [f.location for f in reads] == [
        f"{here}:{_line_of(_promotes, '.item()')}"]


def test_purity_reports_a_raising_program():
    def broken(x):
        raise RuntimeError("shape bug")
    report = Report()
    hs.purity_findings(RoundProgramSpec("broken", "b", "step", broken,
                                        (torch.ones(1),)), report)
    assert [f.check for f in report.findings] == ["hostsync.trace-failure"]


_KEEP = []


def _leaky_step(opt, x):
    _KEEP.append(opt)                    # the old state, held a second time
    return {"mu": opt["mu"] * 0.9 + x}, x


def test_state_release_catches_a_held_optimizer_state():
    report = Report()
    spec = RoundProgramSpec("leaky", "b", "step", _leaky_step,
                            ({"mu": torch.ones(2)}, torch.ones(2)),
                            alias_argnums=(0,))
    out = don.audit_donation(spec, report)
    _KEEP.clear()
    assert [f.check for f in report.findings] == ["donation.must-alias"]
    assert "test_torch_analysis" in report.findings[0].message
    assert out["held"] == 1


@pytest.mark.parametrize("name", ["sequential", "vectorized", "async"])
def test_real_programs_are_pure_and_release_their_state(setups, name):
    adapter, params, datasets, bs, dkind = setups["cnn"]
    runtime = _runtime(name, adapter)
    stack = stack_round(_batchers(datasets, bs, dkind), range(2),
                        local_epochs=1)
    specs = (runtime.trace_specs(params, 1, stack)
             + [runtime.full_reference_spec(params, stack)])
    kinds = {"sequential": ["step", "reference"],
             "vectorized": ["round", "reference"],
             "async": ["local", "aggregation", "reference"]}[name]
    assert [s.kind for s in specs] == kinds
    report = Report()
    for spec in specs:
        hs.purity_findings(spec, report)
        don.audit_donation(spec, report)
    assert not report.findings, report.render()


# --------------------------------------------------------------------------- #
# the contract rules
# --------------------------------------------------------------------------- #
PLANTED = {
    "CON-NPRANDOM": "import numpy as np\nnp.random.seed(0)\n",
    "CON-TORCHRNG": ("import torch\ntorch.manual_seed(0)\nx = torch.randn(3)"
                     "\nx.normal_()\ng = torch.Generator()\n"),
    "CON-LOAD-SEAM": "import ctypes\nlib = ctypes.CDLL('x.so')\n",
}


def _check(tmp_path, rel, text):
    path = tmp_path / "f.py"
    path.write_text(text)
    return contracts.check_file(path, rel)


@pytest.mark.parametrize("rule", sorted(PLANTED))
def test_each_rule_catches_its_violation_and_honours_its_waiver(tmp_path,
                                                                rule):
    rel = "src/repro_torch/models/planted.py"
    found = _check(tmp_path, rel, PLANTED[rule])
    assert found and {f.rule for f in found} == {rule}
    if rule == "CON-TORCHRNG":
        assert [f.line for f in found] == [2, 3, 4, 5]
    waived = "\n".join(line + f"  # contracts: allow={rule}" if line else ""
                       for line in PLANTED[rule].splitlines())
    assert not _check(tmp_path, rel, waived)


def test_torch_rng_allowed_with_a_generator_and_at_the_seams(tmp_path):
    text = ("import torch\ng = torch.Generator()\n"
            "x = torch.randn(3, generator=g)\nx.uniform_(generator=g)\n")
    assert not _check(tmp_path, "src/repro_torch/federated/server.py", text)
    assert not _check(tmp_path, "chip_smoke.py", text)
    assert [f.line for f in _check(
        tmp_path, "src/repro_torch/core/planted.py", text)] == [2]


def test_load_seam_wants_input_checks_before_a_launch(tmp_path):
    rel = "src/repro_torch/kernels/planted/kernel.py"
    bad = "def op(x):\n    _launch('k', x)\n"
    good = ("def op(x):\n    check_kernel_inputs('k', x.device, x=x)\n"
            "    _launch('k', x)\n")
    assert [f.rule for f in _check(tmp_path, rel, bad)] == ["CON-LOAD-SEAM"]
    assert not _check(tmp_path, rel, good)
    assert not _check(tmp_path, "src/repro_torch/kernels/build.py",
                      PLANTED["CON-LOAD-SEAM"])


def test_kernel_ref_rule(tmp_path):
    pkg = tmp_path / "src" / "repro_torch" / "kernels" / "k"
    pkg.mkdir(parents=True)
    (tmp_path / "tests").mkdir()
    (pkg / "kernel.py").write_text("")
    assert [f.rule for f in contracts.check_kernel_refs(tmp_path)] == [
        "CON-KERNEL-REF"]
    (pkg / "ref.py").write_text("")
    assert "no tests" in contracts.check_kernel_refs(tmp_path)[0].message
    (tmp_path / "tests" / "test_torch_k.py").write_text(
        "from repro_torch.kernels.k import kernel, ref\n")
    assert not contracts.check_kernel_refs(tmp_path)


def test_the_ports_tree_is_clean():
    found = contracts.run(contracts.pathlib.Path(__file__).parents[1])
    assert not found, "\n".join(f.render() for f in found)
    assert contracts.main([]) == 0


# --------------------------------------------------------------------------- #
# the harness
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["seq", "vec", "async"])
def test_run_audits_on_the_cpu(backend):
    report = run_audits(backend, device="cpu")
    assert report.ok(), report.render(verbose=True)
    assert [f.check for f in report.findings] == ["memory.unavailable"]
    name = {"seq": "sequential", "vec": "vectorized"}.get(backend, backend)
    assert report.artifacts["hostsync"][f"{name}.run_round"][
        "unsanctioned"] == 0
    for program in ("NeuLiteServer.run_round", "NeuLiteServer.evaluate"):
        assert report.artifacts["hostsync"][program]["to_host"] == 1
