"""The port's Mamba-1 mixer (``repro_torch.models.ssm``) against the JAX
reference, on the CPU, at the jamba-1.5-large-398b smoke config's width
(d_model 256: d_in 512, N 16, dt_rank 16), from the same params (the
reference's init rules through the bridge).

* ``mamba_forward`` at S = 5 (one short chunk), 256 (one whole chunk) and
  300 (a ragged second chunk, zero-padded): the output, the final state h
  and the conv cache, and the gradients of a random cotangent into x and
  every param, at f32 rtol 1e-4 of the largest entry.
* ``mamba_decode``: a prefill of P = 260 then 6 steps against the
  reference's decode from its own prefill cache.
* Quirk Q2 for Mamba: a prompt of P = 2 < K - 1 = 3 tokens.  The port's
  conv cache is (B, 3, d_in), zero-padded in front (the rule of its mLSTM
  cache), and its decode then equals the forward over the whole sequence;
  the reference caches (B, 2, d_in), which its serving pads behind, and its
  decode leaves its own forward.
* The scan at A = -1 (``A_log``'s init) over 256 steps stays finite and
  equal to the plain recurrence where a running product of exp(dt A)
  underflows.
* The full width's dims and dtypes: d_in 16384, dt_rank 512, and
  ``dt_bias``, ``A_log``, ``D`` float32 in the bf16 model; the bridge
  carries a bf16 Mamba sub-layer (float32 leaves included) to the bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.common import paramdef as r_pd
from repro.models import ssm as r_ssm
from repro_torch import bridge
from repro_torch import configs as t_configs
from repro_torch.common.tree import flatten_paths, tree_map
from repro_torch.models import ssm as t_ssm
from test_torch_moe import _rel, init_defs

RTOL = 1e-4
ARCH = "jamba-1.5-large-398b"
B = 2


@pytest.fixture(scope="module")
def setup():
    r_cfg = r_configs.get_smoke_config(ARCH)
    t_cfg = t_configs.get_smoke_config(ARCH)
    params = init_defs(r_ssm.mamba_defs(r_cfg), 0)
    # A_log's init is zeros (A = -1); spread it, as training would
    params["A_log"] = np.random.default_rng(3).uniform(
        -1, 2, params["A_log"].shape).astype(np.float32)
    return r_cfg, t_cfg, params


def _x(S, seed=1, d=256):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


@pytest.mark.parametrize("S", [5, 256, 300])
def test_mamba_forward_matches_reference(setup, S):
    r_cfg, t_cfg, params = setup
    x = _x(S)
    ct = _x(S, seed=2)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))

    @jax.jit
    def run(p, x):
        (y, cache), vjp = jax.vjp(lambda p, x: r_ssm.mamba_forward(
            p, r_cfg, x, pos, with_cache=True), p, x)
        zero = jax.tree.map(jnp.zeros_like, cache)
        return y, cache, vjp((jnp.asarray(ct), zero))
    r_y, r_cache, (r_gp, r_gx) = run(params, x)

    live = tree_map(lambda t: t.clone().requires_grad_(True),
                    bridge.from_reference(params, "cpu"))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, cache = t_ssm.mamba_forward(live, t_cfg, tx, None, with_cache=True)
    torch.sum(y * torch.from_numpy(ct)).backward()
    assert _rel(r_y, y) <= RTOL
    assert cache["h"].dtype == torch.float32
    assert _rel(r_cache["h"], cache["h"]) <= RTOL
    assert tuple(cache["conv"].shape) == (B, 3, 512)
    assert _rel(r_cache["conv"], cache["conv"]) <= RTOL
    assert _rel(r_gx, tx.grad) <= RTOL
    want = flatten_paths(bridge.from_reference(r_gp, "cpu"))
    for k, g in flatten_paths(tree_map(lambda t: t.grad, live)).items():
        assert _rel(want[k], g) <= RTOL, k


def _ref_serve(r_cfg, params, x, P, steps, pad_behind=False):
    """The reference's prefill of x[:, :P] with cache, then ``steps``
    decode steps; with ``pad_behind`` its conv cache is zero-padded behind
    to K - 1 rows (the serving loop's ``grow``)."""
    pos = jnp.broadcast_to(jnp.arange(P)[None], (B, P))
    y, cache = jax.jit(lambda p, x: r_ssm.mamba_forward(
        p, r_cfg, x, pos, with_cache=True))(params, x[:, :P])
    if pad_behind:
        cache["conv"] = jnp.pad(cache["conv"],
                                ((0, 0), (0, 3 - P), (0, 0)))
    dec = jax.jit(lambda p, x, c, t: r_ssm.mamba_decode(p, r_cfg, x, c, t))
    outs = []
    for t in range(P, P + steps):
        o, cache = dec(params, x[:, t:t + 1], cache, t)
        outs.append(o)
    return np.concatenate(outs, 1)


def _port_serve(t_cfg, params, x, P, steps):
    tp = bridge.from_reference(params, "cpu")
    tx = torch.from_numpy(x)
    with torch.no_grad():
        _, cache = t_ssm.mamba_forward(tp, t_cfg, tx[:, :P], None,
                                       with_cache=True)
        assert tuple(cache["conv"].shape) == (B, 3, 512)
        outs = []
        for t in range(P, P + steps):
            o, cache = t_ssm.mamba_decode(tp, t_cfg, tx[:, t:t + 1], cache, t)
            outs.append(o)
    return torch.cat(outs, 1)


def test_mamba_decode_matches_reference(setup):
    r_cfg, t_cfg, params = setup
    P, steps = 260, 6
    x = _x(P + steps, seed=4)
    assert _rel(_ref_serve(r_cfg, params, x, P, steps),
                _port_serve(t_cfg, params, x, P, steps)) <= RTOL


def test_quirk_short_prompt_conv_cache(setup, capsys):
    """Q2 for Mamba: P = 2.  The port's decode equals the forward over the
    whole sequence; the reference's (its (B, 2, d_in) cache padded behind
    to 3 rows, as its serving pads it) does not."""
    r_cfg, t_cfg, params = setup
    P, steps = 2, 4
    x = _x(P + steps, seed=5)
    tp = bridge.from_reference(params, "cpu")
    with torch.no_grad():
        full = t_ssm.mamba_forward(tp, t_cfg, torch.from_numpy(x), None)
    port = _port_serve(t_cfg, params, x, P, steps)
    ref = _ref_serve(r_cfg, params, x, P, steps, pad_behind=True)
    port_err = _rel(full[:, P:], port)
    ref_err = _rel(full[:, P:], ref)
    with capsys.disabled():
        print(f"\n  Mamba, P = {P}: decode against the forward, port "
              f"{port_err:.2e}, reference {ref_err:.2e}")
    assert port_err <= RTOL
    assert ref_err > 100 * RTOL
    # the reference's forward is the port's
    pos = jnp.broadcast_to(jnp.arange(P + steps)[None], (B, P + steps))
    r_full, _ = r_ssm.mamba_forward(params, r_cfg, jnp.asarray(x), pos)
    assert _rel(r_full, full) <= RTOL


def test_scan_at_init_stays_finite():
    """``A_log`` = 0 (A = -1) and dt ~ softplus(0.5) over 256 steps: the
    running product of exp(dt A) reaches ~e^-250, below float32's least
    normal; the scan is the plain recurrence, finite."""
    g = torch.Generator().manual_seed(0)
    Bs, S, d_in, N = 1, 256, 3, 2
    dt = torch.full((Bs, S, d_in), 0.97)
    Bm = torch.randn((Bs, S, N), generator=g)
    Cm = torch.randn((Bs, S, N), generator=g)
    xc = torch.randn((Bs, S, d_in), generator=g)
    A = -torch.ones((d_in, N))
    y, h = t_ssm._mamba_scan(dt, Bm, Cm, xc, A, torch.zeros(Bs, d_in, N))
    assert float(torch.exp((dt[..., None] * A).sum(1)).max()) < 1e-38
    hh, want = torch.zeros(Bs, d_in, N, dtype=torch.float64), []
    for t in range(S):
        hh = (torch.exp(dt[:, t, :, None] * A) * hh
              + (dt[:, t] * xc[:, t])[..., None] * Bm[:, t, None]).double()
        want.append(torch.einsum("bdn,bn->bd", hh, Cm[:, t].double()))
    assert torch.isfinite(y).all()
    assert _rel(torch.stack(want, 1), y) <= 1e-5
    assert _rel(hh, h) <= 1e-5


def test_full_width_dims_dtypes_and_the_bridge():
    r_cfg = r_configs.get_config(ARCH)
    t_cfg = t_configs.get_config(ARCH)
    assert t_ssm.mamba_dims(t_cfg) == r_ssm.mamba_dims(r_cfg) == \
        (16384, 512, 16, 4)
    r_defs = r_ssm.mamba_defs(r_cfg)
    t_defs = t_ssm.mamba_defs(t_cfg)
    for k, d in t_defs.items():
        assert d.shape == tuple(r_defs[k].shape), k
        assert str(d.dtype).split(".")[-1] == \
            jnp.dtype(r_defs[k].dtype).name, k
    assert {k for k, d in t_defs.items() if d.dtype == torch.float32} == \
        {"dt_bias", "A_log", "D"}
    for k, d in t_ssm.mamba_cache_defs(t_cfg, 2).items():
        assert d.shape == tuple(r_ssm.mamba_cache_defs(r_cfg, 2)[k].shape)
    # a bf16 Mamba sub-layer (its float32 leaves kept) across the bridge
    small = dataclasses.replace(r_configs.get_smoke_config(ARCH),
                                dtype="bfloat16")
    params = r_pd.init_params(jax.random.PRNGKey(0),
                              r_ssm.mamba_defs(small))
    got = bridge.from_reference(jax.device_get(params), "cpu")
    back = bridge.reference_layout(got)
    for k, a in params.items():
        a = np.asarray(a)
        t = got[k]
        assert str(t.dtype).split(".")[-1] == str(a.dtype), k
        bits = (a.view(np.uint16) if a.dtype.name == "bfloat16"
                else a.view(np.uint32))
        tbits = (t.view(torch.int16).numpy().view(np.uint16)
                 if t.dtype == torch.bfloat16
                 else t.numpy().view(np.uint32))
        assert np.array_equal(bits, tbits), k
        assert torch.equal(back[k], t), k
