"""The xLSTM on the vectorized round, on the CPU: K5 under ``torch.func``
and the shrunk xlstm-1.3b's rounds through ``VectorizedRuntime``.

* K5's custom ops (``kernels/slstm_scan/kernel.py``, their plain versions
  on the CPU) pass ``torch.library.opcheck``, with and without a leading
  cohort axis; under ``vmap`` the forward and ``vmap(grad)`` of the
  differentiable scan (``ops.slstm_scan``) equal a loop over the cohorts,
  with r and b per cohort (a trainable layer: a cohort axis on the
  kernels) and shared (a frozen layer: the cohorts fold into the rows).
* The shrunk xlstm-1.3b of ``tests/test_torch_xlstm.py`` (d_model 64, 4
  heads, vocab 64, float32; the scan op on the port's side) at 24 layers,
  3 periods in 2 stages, so that stage 1 has a frozen period (its sLSTM
  layer shared by the cohorts, folded into the rows) beside two trainable
  ones (an sLSTM layer of each cohort's own, on the kernels' cohort axis);
  with 16 layers stage 1 freezes nothing.  C = 2 cohorts: the vectorized
  round against the port's sequential round at every stage, at the
  reference's bar between its two runtimes (rtol 1e-4, atol 1e-5); at
  stage 1 against the reference's
  ``VectorizedRuntime`` (its plain scan: interpret-mode Pallas under vmap
  is slow) at 1e-3 of the largest update; the full-model round program
  against the reference's; and ``FLConfig(runtime="vectorized")`` through
  the server.  SGD at lr 1e-3, as ``tests/test_torch_vectorized.py``
  trains its transformer: from the reference's init at 0.05 the stage-1
  round is chaotic (the port's sequential round moved by 7.5e-2 of its
  largest update for a 1e-7 relative change of its start params when this
  test was written, the vectorized round 2.4e-4 from it), at 1e-3 it moves
  4.8e-4.
* ``ModelConfig.reduced`` and ``configs.xlstm_1_3b.smoke_config`` equal the
  reference's, field by field.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_vectorized import (REF_TOL, SEQ_TOL, _assert_trees_close,
                                   _update_rel_err, bridge_batches)

from repro.configs import paper_models as r_paper
from repro.configs import xlstm_1_3b as r_xlstm
from repro.core import CurriculumHP as RHP
from repro.core import make_adapter as r_make_adapter
from repro.data import Batcher as RBatcher
from repro.data import make_lm_dataset
from repro.data.loader import stack_round
from repro.federated import runtime as rrt
from repro.optim import sgd as r_sgd
from repro_torch import bridge
from repro_torch.configs import paper_models as t_paper
from repro_torch.configs import xlstm_1_3b as t_xlstm
from repro_torch.core.curriculum import CurriculumHP as THP
from repro_torch.core.progressive import make_adapter as t_make_adapter
from repro_torch.federated import runtime as trt
from repro_torch.federated.server import FLConfig, NeuLiteServer
from repro_torch.kernels.slstm_scan import kernel, ops
from repro_torch.optim.optimizers import sgd as t_sgd

CPU = torch.device("cpu")
SMALL = dict(num_layers=24, d_model=64, num_heads=4, vocab_size=64,
             dtype="float32")
COHORTS = 2
LR = 1e-3
STATE = ("c", "n", "m", "h")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one thread, as ``tests/test_torch_vectorized.py`` runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# K5 under torch.func
# --------------------------------------------------------------------------- #
def _scan_inputs(C, B=3, S=5, H=2, Dh=4, seed=0):
    """C cohorts' (g_in, r, b, c0, n0, m0, h0), each with a leading C axis;
    random initial states (n0 > 0)."""
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal((C, *shape)) * scale).astype(np.float32))

    st = [draw(B, H, Dh), draw(B, H, Dh).abs() + 0.1, draw(B, H, Dh),
          draw(B, H, Dh, scale=0.5)]
    return [draw(B, S, 4, H, Dh), draw(4, H, Dh, Dh, scale=0.3),
            draw(4, H, Dh, scale=0.1), *st]


def _bwd_args(inputs):
    """The backward op's arguments on ``inputs``' forward: saved states, r,
    the initial c, n, m and seeded cotangents."""
    g_in, r, b, *st = inputs
    saved = kernel.slstm_scan_fwd(g_in, r, b, *st, save=True)[5:]
    rng = np.random.default_rng(9)
    cot = [torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
        np.float32)) for t in (saved[1], *st)]
    return (*saved, r, *st[:3], *cot)


@pytest.mark.parametrize("batched", [False, True],
                         ids=["one-scan", "cohort-axis"])
@pytest.mark.parametrize("op", ["fwd-save", "fwd", "bwd"])
def test_opcheck(op, batched):
    """Schema, fake implementation, dispatch and autograd registration of
    K5's custom ops, unbatched and with a leading cohort axis."""
    inputs = _scan_inputs(3)
    if not batched:
        inputs = [t[0] for t in inputs]
    if op == "bwd":
        torch.library.opcheck(kernel._scan_bwd, _bwd_args(inputs))
    else:
        torch.library.opcheck(kernel._scan_fwd, (*inputs, op == "fwd-save"))


def _loop(fn, args, in_dims):
    """``fn`` on each cohort's slice of the batched ``args``, stacked."""
    outs = [fn(*(a if d is None else a[c] for a, d in zip(args, in_dims)))
            for c in range(args[0].shape[0])]
    if isinstance(outs[0], (tuple, list)):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _close(got, want):
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


SHARING = {"own-r": (0, 0, 0, 0, 0, 0, 0),
           "shared-r": (0, None, None, 0, 0, 0, 0)}


@pytest.mark.parametrize("sharing", list(SHARING))
def test_scan_ops_under_vmap_equal_a_loop(sharing):
    """The forward op (with the saved states) and the backward op under
    ``vmap``: per-cohort r gives the kernels a cohort axis, shared r folds
    the cohorts into the rows."""
    in_dims = SHARING[sharing]
    inputs = _scan_inputs(3, seed=1)
    args = [t[0] if d is None else t for t, d in zip(inputs, in_dims)]

    def fwd(*a):
        return kernel.slstm_scan_fwd(*a, save=True)

    _close(torch.func.vmap(fwd, in_dims=in_dims)(*args),
           _loop(fwd, args, in_dims))
    bwd = _bwd_args(inputs)
    r_dim = in_dims[1]
    bargs = [t[0] if i == 4 and r_dim is None else t
             for i, t in enumerate(bwd)]
    b_dims = tuple(r_dim if i == 4 else 0 for i in range(len(bargs)))
    _close(torch.func.vmap(kernel.slstm_scan_bwd, in_dims=b_dims)(*bargs),
           _loop(kernel.slstm_scan_bwd, bargs, b_dims))


@pytest.mark.parametrize("sharing", list(SHARING))
def test_vmap_grad_of_the_scan_equals_a_loop(sharing):
    """``vmap(grad_and_value)`` through ``ops.slstm_scan``, as the
    vectorized round takes it: the value and the gradients of g_in, r, b
    and the initial state equal a loop over the cohorts, and the plain
    scan's autograd."""
    from repro_torch.kernels.slstm_scan import ref
    in_dims = SHARING[sharing]
    inputs = _scan_inputs(3, seed=2)
    args = [t[0] if d is None else t for t, d in zip(inputs, in_dims)]

    def loss(g, r, b, *st):
        hs, fin = ops.slstm_scan(g, r, b, dict(zip(STATE, st)))
        return (hs * hs).sum() + fin["c"].sum() + fin["m"].mean()

    def plain(g, r, b, *st):
        hs, fin = ref.slstm_scan_ref(g, r, b, dict(zip(STATE, st)))
        return (hs * hs).sum() + fin["c"].sum() + fin["m"].mean()

    argnums = tuple(range(7))
    grad = torch.func.grad_and_value(loss, argnums=argnums)
    grads, value = torch.func.vmap(grad, in_dims=in_dims)(*args)
    for c in range(3):
        a = [t if d is None else t[c] for t, d in zip(args, in_dims)]
        want, want_value = grad(*a)
        _close([g[c] for g in grads] + [value[c]], [*want, want_value])
        for got, p in zip(grads, torch.func.grad(plain, argnums=argnums)(
                *a)):
            torch.testing.assert_close(got[c], p, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("vmapped", [False, True], ids=["one", "cohorts"])
def test_proximal_term_is_autograd_of_the_plain_expression(vmapped):
    """Eq. 5's μ/2 ‖θ − θ^l‖², whose backward recomputes θ − θ^l rather
    than keeping it (the vectorized round's memory at full width): value
    and gradient the bits of autograd of the plain expression, alone and
    under ``vmap(grad)`` over cohorts with a shared ``global_ref``."""
    from repro_torch.core.curriculum import proximal_term
    rng = np.random.default_rng(3)
    ref = {"a": torch.from_numpy(rng.standard_normal((5, 3)).astype(
        np.float32)), "b": [torch.from_numpy(rng.standard_normal(7).astype(
            np.float32))]}
    params = [torch.from_numpy(rng.standard_normal((3, 5, 3)).astype(
        np.float32)), torch.from_numpy(rng.standard_normal((3, 7)).astype(
            np.float32))]

    def port(a, b):
        return proximal_term({"a": a, "b": [b]}, ref, 0.01)

    def plain(a, b):
        return 0.5 * 0.01 * sum(
            torch.sum(torch.square(x.float() - y.float()))
            for x, y in ((a, ref["a"]), (b, ref["b"][0])))

    def run(f):
        grad = torch.func.grad_and_value(f, argnums=(0, 1))
        if vmapped:
            (ga, gb), value = torch.func.vmap(grad)(*params)
        else:
            (ga, gb), value = grad(params[0][0], params[1][0])
        return ga, gb, value

    for got, want in zip(run(port), run(plain), strict=True):
        assert torch.equal(got, want)


# --------------------------------------------------------------------------- #
# the shrunk xlstm-1.3b's rounds
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def xlstm():
    """(reference adapter, its params, port adapter, the bridged params,
    a stack of 2 cohorts x 2 steps of 8 sequences of 20 tokens)."""
    return _setup()


def _setup(**kw):
    r_cfg = dataclasses.replace(r_xlstm.config(), use_slstm_kernel=False,
                                **{**SMALL, **kw})
    t_cfg = dataclasses.replace(t_xlstm.config(), use_slstm_kernel=True,
                                **{**SMALL, **kw})
    r_ad, t_ad = r_make_adapter(r_cfg, 2), t_make_adapter(t_cfg, 2)
    params = jax.device_get(r_ad.init_params(jax.random.PRNGKey(0)))
    ds = make_lm_dataset(0, 32, 20, SMALL["vocab_size"])
    clients = [ds.subset(np.arange(16 * i, 16 * (i + 1)))
               for i in range(COHORTS)]
    stack = stack_round([RBatcher(d, 8, seed=i, kind="lm")
                         for i, d in enumerate(clients)], range(COHORTS),
                        local_epochs=1)
    return r_ad, params, t_ad, bridge.from_reference(params, "cpu"), stack


HP = dict(mu=0.01)


@pytest.mark.parametrize("t", [0, 1])
def test_vectorized_round_matches_sequential(xlstm, t):
    _, _, t_ad, t_params, stack = xlstm
    opt, hp = t_sgd(LR), THP(**HP, use_hsic_kernel=True)
    seq, m_s = trt.SequentialRuntime(t_ad, opt, hp, CPU).run_stacked(
        t_params, t, stack)
    vec, m_v = trt.VectorizedRuntime(t_ad, opt, hp, CPU).run_stacked(
        t_params, t, stack)
    _assert_trees_close(seq, vec, **SEQ_TOL)
    np.testing.assert_allclose(m_s["cohort_losses"].numpy(),
                               m_v["cohort_losses"].numpy(), rtol=1e-4)
    np.testing.assert_allclose(float(m_s["mean_local_loss"]),
                               float(m_v["mean_local_loss"]), rtol=1e-4)


def test_vectorized_round_matches_reference_vectorized(xlstm):
    """Stage 1: a frozen period (its sLSTM layer shared by the cohorts)
    and a trainable one (an sLSTM layer of each cohort's own)."""
    r_ad, r_params, t_ad, t_params, stack = xlstm
    r_new, r_m = rrt.VectorizedRuntime(r_ad, r_sgd(LR), RHP(**HP)
                                       ).run_stacked(r_params, 1, stack)
    new, m = trt.VectorizedRuntime(t_ad, t_sgd(LR), THP(
        **HP, use_hsic_kernel=True), CPU).run_stacked(t_params, 1, stack)
    _, r_start = r_ad.split_stage(r_params, 1)
    _, t_start = t_ad.split_stage(t_params, 1)
    assert _update_rel_err(jax.device_get(r_new), new, r_start,
                           t_start) <= REF_TOL
    r_loss = float(r_m["mean_local_loss"])
    assert abs(float(m["mean_local_loss"]) - r_loss) <= REF_TOL * abs(r_loss)


def test_full_round_program_matches_reference():
    """FedAvg's round over the whole model: every sLSTM layer trainable,
    each cohort's own r and b on the kernels' cohort axis.  At 16 layers
    and lr 1e-4, the card's: at 1e-3 the port's full round moved by 2.2e-3
    of its largest update for a 1e-7 relative change of its params (4.5e-4
    at 1e-4) when this test was written, and at 24 layers it differed from
    the reference's by 2.1e-3 at 1e-4."""
    r_ad, r_params, t_ad, t_params, stack = _setup(num_layers=16)
    r_model = {"model": r_params["model"]}
    t_model = {"model": t_params["model"]}
    lr = 1e-4
    r_new, r_m = rrt.make_full_round_program(r_ad, r_sgd(lr))(
        r_model, jax.tree.map(jax.numpy.asarray, stack.batches),
        jax.numpy.asarray(stack.weights), jax.numpy.asarray(stack.step_mask))
    t_new, t_m = trt.make_full_round_program(t_ad, t_sgd(lr))(
        t_model, bridge_batches(stack), stack.weights, stack.step_mask)
    assert _update_rel_err(jax.device_get(r_new), t_new, r_model,
                           t_model) <= REF_TOL
    np.testing.assert_allclose(t_m["cohort_losses"].numpy(),
                               np.asarray(r_m["cohort_losses"]),
                               rtol=REF_TOL)


def test_flconfig_runs_the_xlstm_vectorized(xlstm):
    """``FLConfig(runtime="vectorized")`` on the xLSTM: the server's round
    has a finite loss and moves the stage's params."""
    _, _, t_ad, t_params, _ = xlstm
    ds = make_lm_dataset(1, 96, 20, SMALL["vocab_size"])
    server = NeuLiteServer(
        t_ad, [ds.subset(np.arange(8 * i, 8 * (i + 1))) for i in range(12)],
        FLConfig(n_devices=12, clients_per_round=2, local_epochs=1,
                 batch_size=8, lr=LR, num_stages=2, use_hsic_kernel=True,
                 runtime="vectorized"),
        data_kind="lm", params=t_params, device="cpu")
    assert isinstance(server.runtime, trt.VectorizedRuntime)
    rr = server.run_round(0)
    assert rr.n_selected > 0 and np.isfinite(rr.mean_loss)
    before = t_params["model"]["layers"]["sub7"]["mixer"]["r"]
    after = server.params["model"]["layers"]["sub7"]["mixer"]["r"]
    assert not torch.equal(before[0], after[0])


# --------------------------------------------------------------------------- #
# the configs
# --------------------------------------------------------------------------- #
def _shared_fields(r_cfg, t_cfg):
    names = ({f.name for f in dataclasses.fields(r_cfg)}
             & {f.name for f in dataclasses.fields(t_cfg)})
    return ({n: getattr(r_cfg, n) for n in names},
            {n: getattr(t_cfg, n) for n in names})


REDUCED = [dict(), dict(num_layers=16), dict(num_layers=3, d_model=96,
                                             vocab=100)]


@pytest.mark.parametrize("kw", REDUCED, ids=["default", "16", "3-96-100"])
@pytest.mark.parametrize("model", ["xlstm", "vit"])
def test_reduced_matches_reference(model, kw):
    if model == "xlstm":
        r_cfg, t_cfg = r_xlstm.config(), t_xlstm.config()
    else:
        r_cfg, t_cfg = r_paper.vit(), t_paper.vit()
    r_fields, t_fields = _shared_fields(r_cfg.reduced(**kw),
                                        t_cfg.reduced(**kw))
    r_fields["xlstm"] = r_fields["xlstm"] and dataclasses.asdict(
        r_fields["xlstm"])
    t_fields["xlstm"] = t_fields["xlstm"] and dataclasses.asdict(
        t_fields["xlstm"])
    assert t_fields == r_fields


def test_smoke_config_matches_reference():
    r_fields, t_fields = _shared_fields(r_xlstm.smoke_config(),
                                        t_xlstm.smoke_config())
    for f in (r_fields, t_fields):
        f["xlstm"] = dataclasses.asdict(f["xlstm"])
    assert t_fields == r_fields
    cfg = t_xlstm.smoke_config()
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.resolved_head_dim, cfg.vocab_size, cfg.dtype) == (
        16, 256, 4, 64, 512, "float32")
