"""The paper's Fig. 2, Fig. 5 and Fig. 8 and the quickstart, the port's
modules against the JAX reference's on the CPU.

Each reference module runs shrunk through the names it imports (as
``tests/test_torch_tables.py`` shrinks the tables): ResNet18 at width 0.125
and 8x8 images, a ViT of d_model 48 and 3 layers at 16x16, the quickstart's
transformer at 4 layers of d_model 32; one or two rounds.  The port's
module runs at the same size from the reference's params through the
bridge.  Cohorts, feasibility, stages and upload bytes must be equal.

The bar (the rule of the other port tests): 1e-3 of a value (of the
largest update for params; one test image of the 512 for an accuracy), or
10x the reference's own movement when its init params are multiplied by
(1 + 1e-7 x a normal draw), where that is larger.  These tiny models are
chaotic in the reference itself (8x8 maps of 1-2 channels a group; the
quickstart's transformer at lr 0.1), so the reference runs each module
twice; the second run reuses the first run's compiled programs (the
recorded servers are reset with ``load_state`` to their state at
construction, and the modules' step builders are memoized).  The
quickstart's memory line equals the reference's to the byte, at the
shrunk size and at its own.
"""
import contextlib
import dataclasses
import io
import re
import runpy

import jax
import numpy as np
import pytest
import torch

import benchmarks.common as r_bcommon
import benchmarks.fig2_hsic_plane as r_fig2
import benchmarks.fig5_scale_vit as r_fig5
import benchmarks.fig8_ablation as r_fig8
import repro.core as r_core
import repro.federated.runtime as r_runtime
import repro.models.config as r_config
from repro.common import paramdef as r_PD
from repro.core import make_adapter as r_make_adapter
from repro.core.memory import estimate_full_memory, stage_memory_table
from repro.data import make_image_dataset as r_make_image_dataset
from repro.models import cnn as r_cnn
from repro_torch import bridge
from repro_torch.benchmarks import fig2_hsic_plane, fig5_scale_vit, fig8_ablation
from repro_torch.core.progressive import make_adapter
from repro_torch.examples import quickstart

TOL = 1e-3
WIDTH, SIZE = 0.125, 8
VIT = dict(image_size=16, d_model=48, num_layers=3)
# the quickstart's model (examples/quickstart.py), and its shrunk widths
QUICKSTART = dict(name="quickstart-12L", family="dense", num_layers=12,
                  d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                  vocab_size=512, dtype="float32")
QUICK = dict(num_layers=4, d_model=32, d_ff=64, vocab_size=64)
ACC_SLACK = 1 / 512 + 1e-12       # one test image of the 512


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def results_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(r_bcommon, "RESULTS_DIR", str(tmp_path))
    return tmp_path


def _eps(tree, seed=1):
    """``tree`` x (1 + 1e-7 x a normal draw), leaf by leaf."""
    g = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) * (1 + 1e-7 * g.standard_normal(
        np.shape(x))).astype(np.float32), jax.device_get(tree))


def _perturbed(ad):
    """The reference adapter ``ad`` whose ``init_params`` is ``_eps`` of
    its own."""
    init = ad.init_params

    class Perturbed(type(ad)):
        def init_params(self, rng):
            return _eps(init(rng))

    return Perturbed(**{f.name: getattr(ad, f.name)
                        for f in dataclasses.fields(ad)})


def _memoized(make, key):
    """``make`` returning one object per ``key(*args)``: a second run of a
    reference module then jits the step functions JAX already compiled."""
    made = {}

    def build(*args):
        k = key(*args)
        if k not in made:
            made[k] = make(*args)
        return made[k]

    return build


def _bar(ref, ref_eps, floor):
    """Each value's bar: ``floor`` or 10x the reference's own movement."""
    return np.maximum(floor, 10 * np.abs(np.asarray(ref, np.float64)
                                         - np.asarray(ref_eps, np.float64)))


def _shrunk_cnn(cfg_cls):
    return lambda _c=cfg_cls, **kw: dataclasses.replace(
        _c(**kw), image_size=SIZE, width_mult=WIDTH)


def _ref_cnn_params(num_classes=10):
    cfg = r_cnn.CNNConfig(name="resnet18", arch="resnet18",
                          num_classes=num_classes, image_size=SIZE,
                          width_mult=WIDTH)
    return cfg, jax.device_get(
        r_make_adapter(cfg, 4).init_params(jax.random.PRNGKey(0)))


def _update_rel_err(new_a, new_b, start):
    """Largest difference of two trees (in the reference's layout) after
    the same rounds from ``start``, over the largest entry of ``new_a``'s
    update."""
    a = [np.asarray(x, np.float64) for x in jax.tree.leaves(new_a)]
    b = [np.asarray(x, np.float64) for x in jax.tree.leaves(new_b)]
    s = [np.asarray(x, np.float64) for x in jax.tree.leaves(start)]
    scale = max(np.abs(x - y).max() for x, y in zip(a, s, strict=True))
    assert scale > 0
    return max(float(np.abs(x - y).max())
               for x, y in zip(a, b, strict=True)) / scale


class _Recorded:
    """A reference module's server class whose instances are kept with
    their state at construction (``save_state``), so that each can rerun
    its rounds from a perturbed start on its compiled programs."""

    def __init__(self, cls, tmp_path):
        self.runs = []
        outer = self

        class Server(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                d = tmp_path / f"server{len(outer.runs)}"
                outer.runs.append({"server": self,
                                   "path": self.save_state(str(d))})

        self.cls = Server

    def rerun_perturbed(self, rounds):
        """Each server's (history, params) of its run, then of its run
        from ``_eps`` of its start params."""
        out = []
        for run in self.runs:
            srv = run["server"]
            first = (list(srv.history), jax.device_get(srv.params))
            srv.load_state(run["path"])
            srv.params = jax.tree.map(jax.numpy.asarray, _eps(srv.params))
            srv.run(rounds)
            out.append((first, (list(srv.history),
                                jax.device_get(srv.params))))
        return out


def _same_rounds(ref, ref_eps, port, start):
    """A port server against the reference's (history, params) of its run
    and of its perturbed run."""
    (hist, params), (hist_eps, params_eps) = ref, ref_eps
    assert len(hist) == len(hist_eps) == len(port.history)
    for rh, eh, th in zip(hist, hist_eps, port.history):
        assert (rh.stage, rh.n_selected, rh.n_feasible, rh.upload_bytes) \
            == (th.stage, th.n_selected, th.n_feasible, th.upload_bytes)
        if rh.n_selected:
            assert abs(th.mean_loss - rh.mean_loss) <= _bar(
                rh.mean_loss, eh.mean_loss, TOL * abs(rh.mean_loss))
        assert abs(th.test_acc - rh.test_acc) <= _bar(
            rh.test_acc, eh.test_acc, ACC_SLACK)
    if any(h.n_selected for h in hist):
        own = _update_rel_err(params, params_eps, start)
        assert _update_rel_err(params, bridge.to_reference(port.params),
                               start) <= max(TOL, 10 * own)


# --------------------------------------------------------------------------- #
# Fig. 2
# --------------------------------------------------------------------------- #
def test_fig2_traces_match_reference(monkeypatch, results_dir):
    monkeypatch.setattr(r_fig2, "CNNConfig", _shrunk_cnn(r_fig2.CNNConfig))
    monkeypatch.setattr(r_fig2, "make_image_dataset",
                        lambda *a, **kw: r_make_image_dataset(
                            *a, **{**kw, "image_size": SIZE}))
    monkeypatch.setattr(r_fig2, "make_full_step", _memoized(
        r_fig2.make_full_step, lambda ad, opt: "full"))
    monkeypatch.setattr(r_fig2, "make_stage_step", _memoized(
        r_fig2.make_stage_step, lambda ad, opt, hp, t: (hp.enabled, t)))
    ref = r_fig2.run(steps=20, quiet=True)
    monkeypatch.setattr(r_fig2, "make_adapter",
                        lambda *a, **kw: _perturbed(r_make_adapter(*a, **kw)))
    ref_eps = r_fig2.run(steps=20, quiet=True)

    _, start = _ref_cnn_params()
    port = fig2_hsic_plane.run(steps=20, quiet=True, device="cpu",
                               width=WIDTH, image_size=SIZE,
                               params=bridge.from_reference(start, "cpu"),
                               out_path=results_dir / "f2.json")
    assert list(port) == list(ref) == list(fig2_hsic_plane.MODES)
    for mode in ref:
        got, want = np.asarray(port[mode]), np.asarray(ref[mode])
        assert got.shape == want.shape == (2, 2)
        bar = _bar(want, ref_eps[mode], TOL * np.abs(want))
        assert (np.abs(got - want) <= bar).all(), (mode, got, want, bar)
        # the first probe, one step in, at 1e-3 itself
        np.testing.assert_allclose(got[0], want[0], rtol=TOL)


# --------------------------------------------------------------------------- #
# Fig. 8
# --------------------------------------------------------------------------- #
def test_fig8_variants_match_reference(monkeypatch, results_dir, tmp_path):
    monkeypatch.setattr(r_fig8, "CNNConfig", _shrunk_cnn(r_fig8.CNNConfig))
    setup = r_fig8.make_fl_setup
    monkeypatch.setattr(r_fig8, "make_fl_setup",
                        lambda seed, _s=setup: _s(seed, image_size=SIZE))
    rec = _Recorded(r_fig8.NeuLiteServer, tmp_path)
    monkeypatch.setattr(r_fig8, "NeuLiteServer", rec.cls)
    fedavg = []

    class FedAvg(r_fig8.FedAvg):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            # its RNGs at construction (the test batcher's shared with
            # the NeuLite variants run before it)
            self.start_rngs = [g.bit_generator.state for g in (
                self.rng, self.test_batcher.rng,
                *(b.rng for b in self.batchers))]
            fedavg.append(self)

    monkeypatch.setattr(r_fig8, "FedAvg", FedAvg)
    cfg, start = _ref_cnn_params()
    fedavg_start = jax.device_get(r_PD.init_params(
        jax.random.PRNGKey(0), r_cnn.cnn_defs(cfg)))
    ref = r_fig8.run(rounds=2, quiet=True)
    runs = rec.rerun_perturbed(2)
    # FedAvg again from its perturbed start on its compiled step
    [fa] = fedavg
    fa_params = jax.device_get(fa.params)
    for g, state in zip((fa.rng, fa.test_batcher.rng,
                         *(b.rng for b in fa.batchers)), fa.start_rngs,
                        strict=True):
        g.bit_generator.state = state
    fa.feasible_hist = []
    fa.params = jax.tree.map(jax.numpy.asarray, _eps(fedavg_start))
    fa_eps = fa.run(2).final_acc
    fa_eps_params = jax.device_get(fa.params)

    servers = {}
    port = fig8_ablation.run(
        rounds=2, quiet=True, device="cpu", width=WIDTH, image_size=SIZE,
        params={"neulite": bridge.from_reference(start, "cpu"),
                "fedavg": bridge.from_reference(fedavg_start, "cpu")},
        out_path=results_dir / "f8.json",
        hooks=lambda name, runner: servers.__setitem__(name, runner))
    assert list(port) == list(ref) == ["neulite", "wo_ca", "wo_pc", "fedavg"]
    for name, (first, eps), run in zip(fig8_ablation.VARIANTS, runs,
                                       rec.runs, strict=True):
        srv = servers[name]
        assert type(run["server"].schedule).__name__ \
            == type(srv.schedule).__name__
        assert run["server"].hp.enabled == srv.hp.enabled
        _same_rounds(first, eps, srv, start)
        accs = [h.test_acc for h in eps[0]][-3:]
        assert abs(port[name] - ref[name]) <= _bar(
            ref[name], sum(accs) / len(accs), ACC_SLACK), name
    assert type(servers["wo_pc"].schedule).__name__ == "SequentialSchedule"
    assert not servers["wo_ca"].hp.enabled
    assert servers["wo_pc"].hp.enabled
    assert abs(port["fedavg"] - ref["fedavg"]) <= _bar(
        ref["fedavg"], fa_eps, ACC_SLACK)
    assert _update_rel_err(fa_params, bridge.to_reference(
        servers["fedavg"].params), fedavg_start) <= max(
        TOL, 10 * _update_rel_err(fa_params, fa_eps_params, fedavg_start))


# --------------------------------------------------------------------------- #
# Fig. 5
# --------------------------------------------------------------------------- #
def test_fig5a_scale_matches_reference(monkeypatch, tmp_path):
    monkeypatch.setattr(r_fig5, "CNNConfig", _shrunk_cnn(r_fig5.CNNConfig))
    monkeypatch.setattr(r_fig5, "make_femnist_like",
                        lambda seed, n: r_make_image_dataset(
                            seed, n, num_classes=62, image_size=SIZE,
                            noise=0.3))
    rec = _Recorded(r_fig5.NeuLiteServer, tmp_path)
    monkeypatch.setattr(r_fig5, "NeuLiteServer", rec.cls)
    _, start = _ref_cnn_params(num_classes=62)
    ref = r_fig5.run_scale(scales=(24,), rounds=1, quiet=True)
    [(first, eps)] = rec.rerun_perturbed(1)
    servers = {}
    port = fig5_scale_vit.run_scale(
        scales=(24,), rounds=1, quiet=True, device="cpu", width=WIDTH,
        image_size=SIZE, params=bridge.from_reference(start, "cpu"),
        hooks=lambda name, srv: servers.__setitem__(name, srv))
    assert list(port) == list(ref) == [24]
    port_srv = servers["scale 24"]
    assert port_srv.runtime.name == "sequential"
    assert port_srv.history[0].n_selected == 2
    assert (port[24], ref[24]) == (port_srv.history[-1].test_acc,
                                   first[0][-1].test_acc)
    _same_rounds(first, eps, port_srv, start)


def test_fig5b_vit_round_matches_reference(monkeypatch, tmp_path):
    vit = r_fig5.vit
    monkeypatch.setattr(r_fig5, "vit", lambda **kw: vit(**{**kw, **VIT}))
    monkeypatch.setattr(r_fig5, "make_image_dataset",
                        lambda *a, **kw: r_make_image_dataset(
                            *a, **{**kw, "image_size": VIT["image_size"]}))
    rec = _Recorded(r_fig5.NeuLiteServer, tmp_path)
    monkeypatch.setattr(r_fig5, "NeuLiteServer", rec.cls)
    start = jax.device_get(r_make_adapter(vit(num_classes=32, **VIT), 3)
                           .init_params(jax.random.PRNGKey(0)))
    ref = r_fig5.run_vit(rounds=1, quiet=True)
    [(first, eps)] = rec.rerun_perturbed(1)
    servers = {}
    port = fig5_scale_vit.run_vit(
        rounds=1, quiet=True, device="cpu",
        params=bridge.from_reference(start, "cpu"),
        hooks=lambda name, srv: servers.__setitem__(name, srv), **VIT)
    port_srv = servers["vit"]
    assert port_srv.runtime.name == "vectorized"
    assert port_srv.adapter.cfg.use_flash_kernel
    assert port_srv.history[0].n_selected > 0
    assert (port, ref) == (port_srv.history[-1].test_acc,
                           first[0][-1].test_acc)
    _same_rounds(first, eps, port_srv, start)


# --------------------------------------------------------------------------- #
# the quickstart
# --------------------------------------------------------------------------- #
_ROUND = re.compile(r"round +(\d+) \| stage (\d) \| ce ([\d.]+) \| "
                    r"nHSIC\(X;Z\) ([\d.]+) \| nHSIC\(Y;Z\) ([\d.]+)")
_RUNTIME = re.compile(r"  (sequential|vectorized) +loss ([\d.]+)")


def _reference_quickstart(monkeypatch, perturb=False):
    """The reference's quickstart as (memory line, each round's [ce,
    nHSIC(X;Z), nHSIC(Y;Z)], {runtime: loss}); with ``perturb`` from
    ``_eps`` of its init params."""
    if perturb:
        monkeypatch.setattr(r_core, "make_adapter",
                            lambda *a, **kw: _perturbed(
                                r_make_adapter(*a, **kw)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path("examples/quickstart.py", run_name="quickstart")
    out = buf.getvalue()
    rounds = [m.groups() for m in _ROUND.finditer(out)]
    assert [int(r) for r, *_ in rounds] == list(range(16))
    return (out.splitlines()[0],
            np.asarray([[float(v) for v in vals] for _, _, *vals in rounds]),
            {k: float(v) for k, v in _RUNTIME.findall(out)})


def test_quickstart_matches_reference(monkeypatch):
    real = r_config.ModelConfig
    monkeypatch.setattr(r_config, "ModelConfig",
                        lambda **kw: real(**{**kw, **QUICK}))
    monkeypatch.setattr(r_core, "make_stage_step", _memoized(
        r_core.make_stage_step, lambda ad, opt, hp, t: t))
    monkeypatch.setattr(r_runtime, "make_runtime", _memoized(
        r_runtime.make_runtime, lambda name, *a, **kw: name))
    line, ref_rounds, ref_rt = _reference_quickstart(monkeypatch)
    _, eps_rounds, eps_rt = _reference_quickstart(monkeypatch, perturb=True)
    start = jax.device_get(r_make_adapter(real(**{**QUICKSTART, **QUICK}),
                                          4).init_params(
        jax.random.PRNGKey(0)))

    port_real = quickstart.ModelConfig
    monkeypatch.setattr(quickstart, "ModelConfig",
                        lambda **kw: port_real(**{**kw, **QUICK}))
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        out = quickstart.main(device="cpu",
                              params=bridge.from_reference(start, "cpu"))
    assert buf.getvalue().splitlines()[0] == line == out["memory_line"]
    assert [t for t, *_ in out["rounds"]] == [r % 4 for r in range(16)]
    got = np.asarray([vals for _, *vals in out["rounds"]])
    assert np.isfinite(got).all()
    # the reference prints ce to 4 decimals and each nHSIC to 3
    half_digit = 0.5 * np.asarray([1e-4, 1e-3, 1e-3])
    # the reference's movement by round r: the most it moved up to r (one
    # draw can move a chaotic round less than the round before it: round
    # 11's ce by 4.7e-3 after round 10's by 1.7e-2)
    move = np.maximum.accumulate(np.abs(ref_rounds - eps_rounds), axis=0)
    bar = np.maximum(TOL * np.abs(ref_rounds), 10 * move) + half_digit
    bad = np.argwhere(np.abs(got - ref_rounds) > bar)
    assert not len(bad), [(r, c, got[r, c], ref_rounds[r, c], eps_rounds[r, c],
                           bar[r, c]) for r, c in bad]
    seq, vec = (out["runtimes"][k][0] for k in ("sequential", "vectorized"))
    assert abs(seq - vec) <= 1e-4 * abs(seq)
    assert ref_rt.keys() == out["runtimes"].keys()
    for name, (loss, _) in out["runtimes"].items():
        assert abs(loss - ref_rt[name]) <= _bar(
            ref_rt[name], eps_rt[name], TOL * ref_rt[name]) + 5e-5, name


def test_quickstart_memory_line_at_its_own_size():
    """The full-size quickstart model's memory line, the port's against
    the reference's numbers in the reference's format."""
    ref_ad = r_make_adapter(r_config.ModelConfig(**QUICKSTART),
                            quickstart.NUM_STAGES)
    B, S = quickstart.BATCH, quickstart.SEQ
    full = estimate_full_memory(ref_ad, B, S)
    peak = max(e.total for e in stage_memory_table(ref_ad, B, S))
    want = (f"peak training memory: full={full.total/1e6:.1f}MB -> "
            f"progressive={peak/1e6:.1f}MB "
            f"({100*(1-peak/full.total):.1f}% reduction)")
    assert quickstart.memory_line(make_adapter(quickstart.config(), 4)) \
        == want
