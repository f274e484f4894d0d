"""The xLSTM path of the port against the JAX reference, on the CPU.

* The mLSTM and sLSTM mixers alone (``models/ssm.py``), forward and VJP at
  rtol 1e-4, the mLSTM also over several chunks (``_MLSTM_CHUNK`` set to 8
  on both sides, S=20, which also pads the last chunk), the sLSTM with the
  scan op (``use_slstm_kernel``) and with the plain per-step loop.
* A shrunk xlstm-1.3b: 16 layers (2 periods of 7 mLSTM + 1 sLSTM), d_model
  64, 4 heads, vocab 64, float32, ``use_slstm_kernel`` on and off: the
  forward, one stage step per stage at rtol 1e-4 of the largest update,
  and two rounds of the sequential server from bridged params (update at
  1e-3, see ``test_two_rounds_match``).
* The full-width xlstm-1.3b: param counts and the memory model, from the
  ParamDefs alone (nothing is allocated); each mixer at full width
  against the reference; and a pin of why a whole full-width step is
  compared per layer, and trained at a lower lr, on the card
  (``test_full_width_step_is_sensitive_and_lr_0_05_diverges``).

Params come from the reference's init and cross through ``bridge.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_vit import _batches, _check_step, _close, _ref_step, \
    _update_err

from repro import optim as r_optim
from repro.common import paramdef as r_pd
from repro.configs import xlstm_1_3b as r_xlstm
from repro.core import make_adapter as r_make_adapter
from repro.core import memory as r_memory
from repro.core.curriculum import CurriculumHP as RHP
from repro.core.progressive import make_stage_step as r_make_step
from repro.data import Batcher, dirichlet_partition, make_lm_dataset
from repro.federated.server import FLConfig as RFLConfig
from repro.federated.server import NeuLiteServer as RServer
from repro.models import ssm as r_ssm
from repro_torch import bridge
from repro_torch.common import paramdef as t_pd
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import xlstm_1_3b as t_xlstm
from repro_torch.core import memory as t_memory
from repro_torch.core.progressive import make_adapter as t_make_adapter
from repro_torch.federated.server import FLConfig as TFLConfig
from repro_torch.federated.server import NeuLiteServer as TServer
from repro_torch.kernels.slstm_scan import kernel as t_slstm_kernel
from repro_torch.models import ssm as t_ssm

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the test processes share the cores, and each
    running a pool of threads slows every one of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(num_layers=16, d_model=64, num_heads=4, vocab_size=64,
             dtype="float32")


def _cfgs(kernel: bool, **kw):
    kw = {**SMALL, **kw}
    return (dataclasses.replace(r_xlstm.config(), use_slstm_kernel=kernel,
                                **kw),
            dataclasses.replace(t_xlstm.config(), use_slstm_kernel=kernel,
                                **kw))


# --------------------------------------------------------------------------- #
# the mixers alone
# --------------------------------------------------------------------------- #
def _mixer_check(kind, kernel, B=2, S=20, **kw):
    r_cfg, t_cfg = _cfgs(kernel, **kw)
    defs = getattr(r_ssm, f"{kind}_defs")(r_cfg)
    params = jax.device_get(r_pd.init_params(jax.random.PRNGKey(3), defs))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, r_cfg.d_model)).astype(np.float32)
    g = rng.standard_normal((B, S, r_cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    r_fwd = getattr(r_ssm, f"{kind}_forward")

    def fn(p, x_):
        return r_fwd(p, r_cfg, x_, jnp.asarray(pos))[0]

    y, vjp = jax.vjp(fn, jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    r_dp, r_dx = vjp(jnp.asarray(g))
    t_params = tree_map(lambda a: a.requires_grad_(True),
                        bridge.from_reference(params, "cpu"))
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    ty = getattr(t_ssm, f"{kind}_forward")(t_params, t_cfg, tx,
                                           torch.from_numpy(pos.copy()))
    _close(y, ty)
    grads = torch.autograd.grad(ty, [tx] + tree_leaves(t_params),
                                torch.from_numpy(g))
    _close(r_dx, grads[0])
    r_leaves = jax.tree.leaves(jax.device_get(r_dp))
    for r_leaf, t_leaf in zip(r_leaves, grads[1:], strict=True):
        _close(r_leaf, t_leaf)


@pytest.mark.parametrize("chunk", [128, 8])
def test_mlstm_mixer_matches(monkeypatch, chunk):
    """One chunk (S=20 < 128), and three chunks of 8 with a padded tail."""
    monkeypatch.setattr(r_ssm, "_MLSTM_CHUNK", chunk)
    monkeypatch.setattr(t_ssm, "_MLSTM_CHUNK", chunk)
    _mixer_check("mlstm", False)


@pytest.mark.parametrize("kernel", [False, True])
def test_slstm_mixer_matches(kernel):
    _mixer_check("slstm", kernel)


def test_causal_conv_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 5)).astype(np.float32)
    w = rng.standard_normal((5, 4)).astype(np.float32)
    _close(r_ssm.causal_conv(jnp.asarray(x), jnp.asarray(w)),
           t_ssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w)))


# --------------------------------------------------------------------------- #
# the shrunk xlstm-1.3b
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def small_xlstm():
    r_cfg, _ = _cfgs(False)
    params = r_make_adapter(r_cfg, 2).init_params(jax.random.PRNGKey(0))
    params = jax.device_get(params)
    t_params = bridge.from_reference(params, "cpu")
    ds = make_lm_dataset(0, 8, 20, SMALL["vocab_size"])
    batch = Batcher(ds, 8, kind="lm").make_batch(np.arange(8))
    return params, t_params, batch


def test_bridge_keeps_xlstm_layouts(small_xlstm):
    """The xLSTM's stacked leaves cross unchanged, values and layouts
    (only a CNN conv's ``"w"`` is permuted): ``w_in`` (P, 4, d, H, Dh),
    ``r`` (P, 4, H, Dh, Dh), ``wq`` (P, d, H, Dh), ``conv_w`` (P, d_in, 4)
    among them; and back again."""
    params, t_params, _ = small_xlstm
    layers, t_layers = params["model"]["layers"], t_params["model"]["layers"]
    shapes = {("sub7", "w_in"): (2, 4, 64, 4, 16),
              ("sub7", "r"): (2, 4, 4, 16, 16),
              ("sub0", "wq"): (2, 64, 4, 16),
              ("sub0", "conv_w"): (2, 64, 4)}
    for (sub, k), shape in shapes.items():
        assert layers[sub]["mixer"][k].shape == shape
        np.testing.assert_array_equal(
            t_layers[sub]["mixer"][k].numpy(), layers[sub]["mixer"][k])
    back = bridge.to_reference(t_params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back),
                    strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _adapters(kernel):
    r_cfg, t_cfg = _cfgs(kernel)
    return r_make_adapter(r_cfg, 2), t_make_adapter(t_cfg, 2)


@pytest.mark.parametrize("kernel", [False, True])
def test_forward_matches(small_xlstm, kernel):
    params, t_params, batch = small_xlstm
    adapter, t_adapter = _adapters(kernel)
    assert [kind for kind, _ in t_adapter.cfg.pattern] == ["mlstm"] * 7 + [
        "slstm"]
    assert [tuple(b) for b in t_adapter.plan.bounds] == [(0, 1), (1, 2)]
    r_batch, t_batch = _batches(batch)
    _close(adapter.forward_eval(params, r_batch["inputs"]),
           t_adapter.forward_eval(t_params, t_batch["inputs"]))


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("t", [0, 1])
def test_stage_step_matches(small_xlstm, t, kernel):
    params, t_params, batch = small_xlstm
    adapter, t_adapter = _adapters(kernel)
    r_batch, t_batch = _batches(batch)
    t_slstm_kernel.reset_launches()
    _check_step(t_adapter, t_params, t_batch,
                _ref_step(adapter, params, r_batch, t), t)
    # on the CPU the scan wrapper takes its plain version: no launch
    assert t_slstm_kernel.LAUNCHES == {"slstm_scan_fwd": 0,
                                       "slstm_scan_bwd": 0}


ROUND_TOL = 1e-3


def test_two_rounds_match(small_xlstm):
    """Two rounds (stages 0 and 1), sLSTM through the scan op on both
    sides: cohorts, feasibility, step counts and upload bytes identical,
    loss at rtol 1e-4, the params' update at 1e-3 of the largest update,
    the round bar of ``tests/test_torch_round.py`` and
    ``tests/test_torch_vit.py``.  (On this fixture the port differed from
    the reference by 4.2e-5 of the largest update when this test was
    written, and the reference from itself, started from params x
    (1 + 1e-7), by 8.5e-5: this model is not chaotic at init as the ViT
    is, but two rounds do use up most of 1e-4.)"""
    params, _, _ = small_xlstm
    adapter, t_adapter = _adapters(True)
    fl = dict(n_devices=12, clients_per_round=2, local_epochs=1,
              batch_size=8, lr=0.05, num_stages=2, mu=0.01, seed=0)
    ds = make_lm_dataset(0, 96, 20, SMALL["vocab_size"])
    parts = dirichlet_partition(0, ds.topics, fl["n_devices"], alpha=1.0)
    clients = [ds.subset(p) for p in parts]
    ref = RServer(adapter, clients, RFLConfig(**fl), data_kind="lm")
    ref.params = params
    ref.run(2)
    port = TServer(t_adapter, clients, TFLConfig(**fl, use_hsic_kernel=True),
                   data_kind="lm", params=bridge.from_reference(params, "cpu"),
                   device="cpu")
    port.run(2)
    assert [h.stage for h in ref.history] == [0, 1]
    for rh, th in zip(ref.history, port.history, strict=True):
        assert (rh.round_idx, rh.stage, rh.n_selected, rh.n_feasible,
                rh.upload_bytes) == (th.round_idx, th.stage, th.n_selected,
                                     th.n_feasible, th.upload_bytes)
        assert rh.n_selected > 0
        assert abs(th.mean_loss - rh.mean_loss) <= 1e-4 * abs(rh.mean_loss)
    assert _update_err(ref.params, bridge.to_reference(port.params),
                       params) <= ROUND_TOL


# --------------------------------------------------------------------------- #
# the full-width xlstm-1.3b, from ParamDefs only
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def full_adapters():
    out = {}
    for dtype in ("float32", "bfloat16"):
        r_cfg = dataclasses.replace(r_xlstm.config(), use_slstm_kernel=True,
                                    dtype=dtype)
        t_cfg = dataclasses.replace(t_xlstm.config(), use_slstm_kernel=True,
                                    dtype=dtype)
        out[dtype] = (r_make_adapter(r_cfg, 3), t_make_adapter(t_cfg, 3))
    return out


def test_full_width_param_counts(full_adapters):
    adapter, t_adapter = full_adapters["float32"]
    cfg = t_adapter.cfg
    assert (cfg.d_model, cfg.num_periods, cfg.num_heads) == (2048, 6, 4)
    mixer = t_adapter.defs["model"]["layers"]["sub7"]["mixer"]
    assert mixer["r"].shape == (6, 4, 4, 512, 512)
    assert mixer["ffn_gate"].shape == (6, 2048, 2752)
    assert t_pd.nparams(t_adapter.defs["model"]) == r_pd.nparams(
        adapter.defs["model"]) == 1_491_568_976
    assert t_pd.nparams(t_adapter.defs) == r_pd.nparams(adapter.defs) \
        == 1_508_637_008
    assert [tuple(b) for b in t_adapter.plan.bounds] == [(0, 2), (2, 4),
                                                         (4, 6)]
    for t in range(3):
        _, r_train = adapter.split_stage(adapter.defs, t)
        _, t_train = t_adapter.split_stage(t_adapter.defs, t)
        assert t_pd.nparams(t_train) == r_pd.nparams(r_train)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_width_memory_model_identical(full_adapters, dtype):
    """Stage and full-model estimates at batch 16, seq 256, byte for byte:
    the fleet's feasibility draw depends on them."""
    adapter, t_adapter = full_adapters[dtype]
    for t in range(3):
        r_est = r_memory.estimate_stage_memory(adapter, t, 16, seq=256)
        t_est = t_memory.estimate_stage_memory(t_adapter, t, 16, seq=256)
        assert dataclasses.astuple(t_est) == dataclasses.astuple(r_est)
        assert t_est.act_bytes > 0
    assert dataclasses.astuple(
        t_memory.estimate_full_memory(t_adapter, 16, seq=256)) == \
        dataclasses.astuple(r_memory.estimate_full_memory(adapter, 16,
                                                          seq=256))



@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_full_width_mixer_matches(kind):
    """The mLSTM and sLSTM mixers of the full-width model (d_model 2048,
    4 heads of 512, ``mlstm_expand=1``, sLSTM FFN 2752; batch 1, seq 8),
    forward and VJP at rtol 1e-4: the per-layer check that stays well
    posed where a whole step does not (next test)."""
    _mixer_check(kind, kind == "slstm", B=1, S=8, d_model=2048)


def test_full_width_step_is_sensitive_and_lr_0_05_diverges():
    """Why whole-step parity is not checked at full width, and why
    ``chip_smoke.py`` trains xlstm-1.3b at lr 1e-4.  One period of the
    full-width model (7 mLSTM + 1 sLSTM at d_model 2048; vocab 64, batch
    4, seq 8), one stage, SGD at lr 0.05 (momentum 0.9, the ``FLConfig``
    default), reference only:

    * a change of 1e-7 in the start params moves the first step's params
      by more than 1e-3 of its largest update (6.1e-3 when this test was
      written): the stacked mLSTM layers amplify f32 rounding, as the
      ViT's attention does (``tests/test_torch_vit.py``), so any
      reordering of sums, the port's included, may move a whole step by as
      much;
    * by the second step the params have moved by ||dθ||² > 2e3 (the
      proximal term μ/2 ||dθ||², μ = 0.01, exceeds 10; 65.8 when written):
      the default lr diverges on this model at the reference's init
      (``wq``/``wk`` take their fan-in from the 4-head axis)."""
    cfg = dataclasses.replace(r_xlstm.config(), num_layers=8, vocab_size=64,
                              dtype="float32")
    adapter = r_make_adapter(cfg, 1)
    params = adapter.init_params(jax.random.PRNGKey(0))
    ds = make_lm_dataset(0, 4, 8, 64)
    r_batch, _ = _batches(Batcher(ds, 4, kind="lm").make_batch(np.arange(4)))
    opt = r_optim.sgd(0.05)
    rf, rt = adapter.split_stage(params, 0)
    # XLA's constant folding takes most of this step's compile time
    step = jax.jit(r_make_step(adapter, opt, RHP(mu=0.01), 0)).lower(
        opt.init(rt), rt, rf, r_batch, rt).compile(
            {"xla_disable_hlo_passes": "constant_folding"})
    state, r1, _ = step(opt.init(rt), rt, rf, r_batch, rt)
    _, _, m2 = step(state, r1, rf, r_batch, rt)
    rt_eps = jax.tree.map(lambda a: a * (1 + 1e-7), rt)
    _, r1_eps, _ = step(opt.init(rt_eps), rt_eps, rf, r_batch, rt_eps)

    def max_diff(x, y):
        return max(float(jnp.abs(a - b).max()) for a, b in
                   zip(jax.tree.leaves(x), jax.tree.leaves(y)) if a.size)

    scale, self_diff = max_diff(r1, rt), max_diff(r1, r1_eps)
    assert self_diff / scale > 1e-3
    assert float(m2["prox"]) > 10
