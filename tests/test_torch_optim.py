"""The port's optimizers and schedules (``repro_torch.optim``) against the
JAX reference's (``repro.optim``), on the CPU.

* ``adamw`` (constant lr and a ``warmup_cosine`` schedule, a float32 and a
  bfloat16 leaf), ``sgd`` with Nesterov momentum, plain momentum and none,
  over six updates from the same params and gradients: every update and
  state leaf at rtol 1e-5 of its largest entry, the step counter equal.
* ``clip_by_global_norm`` below and above its threshold: the clipped
  gradients and the norm at 1e-5.
* ``constant_schedule``, ``cosine_schedule`` and ``warmup_cosine`` at step
  0, inside the warm-up, at its end, past it and past the total, as device
  tensors and as ints.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as r_optim
from repro_torch import optim as t_optim

RTOL = 1e-5
STEPS = 6


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _close(ref, port, tol=RTOL):
    ref, port = _np(ref), _np(port)
    assert ref.shape == port.shape, (ref.shape, port.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= tol, err


def _trees(seed, bf16=False):
    """(params, [grads per step]) as numpy trees; the port side converts."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((5, 7)).astype(np.float32),
              "b": {"x": rng.standard_normal((3,)).astype(np.float32)}}
    grads = [{"w": rng.standard_normal((5, 7)).astype(np.float32),
              "b": {"x": (0.1 * rng.standard_normal((3,)))
                    .astype(np.float32)}} for _ in range(STEPS)]
    return params, grads


def _to_jnp(tree, dtype):
    return {"w": jnp.asarray(tree["w"], dtype),
            "b": {"x": jnp.asarray(tree["b"]["x"], jnp.float32)}}


def _to_torch(tree, dtype):
    return {"w": torch.from_numpy(tree["w"]).to(dtype),
            "b": {"x": torch.from_numpy(tree["b"]["x"])}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [] if tree is None else [tree]


def _run(make_r, make_t, bf16=False):
    params, grads = _trees(0)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    rp, tp = _to_jnp(params, jdt), _to_torch(params, tdt)
    ropt, topt = make_r(), make_t()
    rs, ts = ropt.init(rp), topt.init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    for g in grads:
        ru, rs = ropt.update(_to_jnp(g, jdt), rs, rp)
        tu, ts = topt.update(_to_torch(g, tdt), ts, tp)
        for a, b in zip(_leaves(ru), _leaves(tu)):
            assert b.dtype == (torch.bfloat16 if a.dtype == jnp.bfloat16
                               else torch.float32)
            _close(a, b, 1e-2 if a.dtype == jnp.bfloat16 else RTOL)
        rp = r_optim.apply_updates(rp, ru)
        tp = t_optim.apply_updates(tp, tu)
        for k in rs:
            if k == "step":
                assert int(rs[k]) == int(ts[k])
                continue
            for a, b in zip(_leaves(rs[k]), _leaves(ts[k])):
                assert b.dtype == torch.float32
                _close(a, b)
    for a, b in zip(_leaves(rp), _leaves(tp)):
        _close(a, b, 1e-2 if bf16 else RTOL)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("sched", ["constant", "warmup_cosine"])
def test_adamw_matches_reference(sched, bf16):
    def lr(mod):
        return (3e-3 if sched == "constant"
                else mod.warmup_cosine(3e-3, 2, STEPS))
    _run(lambda: r_optim.adamw(lr(r_optim)),
         lambda: t_optim.adamw(lr(t_optim)), bf16)


@pytest.mark.parametrize("kw", [dict(nesterov=True), dict(nesterov=False),
                                dict(momentum=0.0),
                                dict(nesterov=True, weight_decay=0.0)])
def test_sgd_matches_reference(kw):
    _run(lambda: r_optim.sgd(0.05, **kw), lambda: t_optim.sgd(0.05, **kw))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, grads = _trees(1)
    rg, rn = r_optim.clip_by_global_norm(_to_jnp(grads[0], jnp.float32),
                                         max_norm)
    tg, tn = t_optim.clip_by_global_norm(_to_torch(grads[0], torch.float32),
                                         max_norm)
    _close(rn, tn)
    for a, b in zip(_leaves(rg), _leaves(tg)):
        _close(a, b)
    if max_norm > float(tn):
        # below the threshold the gradients pass unchanged
        for a, b in zip(_leaves(tg), _leaves(_to_torch(grads[0],
                                                       torch.float32))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_reference(name):
    def make(mod):
        return {"constant": lambda: mod.constant_schedule(0.1),
                "cosine": lambda: mod.cosine_schedule(0.1, 10, 0.2),
                "warmup_cosine": lambda: mod.warmup_cosine(0.1, 4, 12)}[name]()
    r_fn, t_fn = make(r_optim), make(t_optim)
    # 0, inside the warm-up, its end, past it, past the total
    for step in (0, 1, 3, 4, 7, 12, 20):
        want = r_fn(jnp.asarray(step, jnp.int32))
        for arg in (torch.tensor(step, dtype=torch.int32), step):
            got = t_fn(arg)
            assert torch.is_tensor(got) and got.dtype == torch.float32
            assert got.dim() == 0
            np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                       atol=1e-9)
