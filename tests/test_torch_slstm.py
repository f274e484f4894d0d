"""The port's sLSTM scan op (K5) against the JAX reference, on the CPU.

The same numpy inputs go through ``repro.kernels.slstm_scan.ops.slstm_scan``
(the Pallas kernel in interpret mode, as ``tests/test_kernel_slstm.py`` runs
it) and ``repro_torch.kernels.slstm_scan.ops.slstm_scan`` (the CUDA kernel's
wrapper, which takes its plain version for CPU tensors).  Forward (``hs``
and the four final states) at 1e-5 absolute; the gradients to ``g_in``,
``r``, ``b`` and the initial state, for one cotangent of every output, at
1e-4 absolute, or 1e-4 of the gradient's largest entry where that exceeds
1 (``r``'s gradient sums over every step and batch row: at Dh=512 its
entries reach ~20, where f32 rounding of the two sums alone is ~1e-5 of
them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.slstm_scan.ops import slstm_scan as r_slstm_scan
from repro_torch.kernels.slstm_scan import kernel as t_kernel
from repro_torch.kernels.slstm_scan import ops as t_ops
from repro_torch.kernels.slstm_scan import ref as t_ref

STATE = ("c", "n", "m", "h")
FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4

# (B, S, H, Dh, block_s, random_state0): S off the sequence block, Dh of 1,
# random non-zero initial states (as the reference's fuzzer draws them)
CASES = [(2, 12, 2, 8, 4, False), (1, 13, 2, 8, 4, False),
         (2, 20, 1, 1, 8, False), (2, 9, 4, 3, 4, True),
         (1, 1, 2, 16, 8, True), (2, 17, 2, 16, 8, True)]


def _inputs(B, S, H, Dh, random_state0, seed=0):
    rng = np.random.default_rng(seed + 100 * S + Dh)
    f = np.float32
    g_in = (rng.standard_normal((B, S, 4, H, Dh)) * 0.5).astype(f)
    r = (rng.standard_normal((4, H, Dh, Dh)) * 0.1).astype(f)
    b = (rng.standard_normal((4, H, Dh)) * 0.1).astype(f)
    if random_state0:
        st = {"c": rng.standard_normal((B, H, Dh)),
              "n": np.abs(rng.standard_normal((B, H, Dh))) + 0.1,
              "m": rng.standard_normal((B, H, Dh)),
              "h": rng.standard_normal((B, H, Dh)) * 0.5}
    else:
        z = np.zeros((B, H, Dh))
        st = {"c": z, "n": z, "m": z - 30.0, "h": z}
    st = {k: v.astype(f) for k, v in st.items()}
    cot = [(rng.standard_normal((B, S, H, Dh))).astype(f)] + [
        rng.standard_normal((B, H, Dh)).astype(f) for _ in STATE]
    return g_in, r, b, st, cot


def _reference(g_in, r, b, st, cot, block_s):
    def fn(g_, r_, b_, st_):
        hs, fin = r_slstm_scan(g_, r_, b_, st_, block_s=block_s,
                               interpret=True)
        return hs, tuple(fin[k] for k in STATE)

    (hs, fin), vjp = jax.vjp(fn, *(jax.tree.map(jnp.asarray, a)
                                   for a in (g_in, r, b, st)))
    grads = vjp((jnp.asarray(cot[0]), tuple(map(jnp.asarray, cot[1:]))))
    return (np.asarray(hs), [np.asarray(x) for x in fin],
            jax.device_get(grads))


def _port(g_in, r, b, st, cot):
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
              for a in (g_in, r, b, *(st[k] for k in STATE))]
    hs, fin = t_ops.slstm_scan(*leaves[:3], dict(zip(STATE, leaves[3:])))
    outs = [hs] + [fin[k] for k in STATE]
    grads = torch.autograd.grad(outs, leaves,
                                [torch.from_numpy(c) for c in cot])
    return (hs.detach().numpy(), [fin[k].detach().numpy() for k in STATE],
            [g.numpy() for g in grads])


def _compare(case):
    B, S, H, Dh, block_s, rs = case
    g_in, r, b, st, cot = _inputs(B, S, H, Dh, rs)
    r_hs, r_fin, (r_dg, r_dr, r_db, r_dst) = _reference(g_in, r, b, st, cot,
                                                         block_s)
    t_hs, t_fin, t_grads = _port(g_in, r, b, st, cot)
    np.testing.assert_allclose(t_hs, r_hs, rtol=0, atol=FWD_ATOL)
    for a, want in zip(t_fin, r_fin, strict=True):
        np.testing.assert_allclose(a, want, rtol=0, atol=FWD_ATOL)
    r_grads = [r_dg, r_dr, r_db] + [r_dst[k] for k in STATE]
    assert all(np.abs(g).max() > 0 for g in r_grads[:3])
    for a, want in zip(t_grads, r_grads, strict=True):
        np.testing.assert_allclose(
            a, want, rtol=0, atol=GRAD_ATOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_slstm_scan_matches_reference(case):
    t_kernel.reset_launches()
    _compare(case)
    # on the CPU the wrapper takes its plain version: no launch
    assert t_kernel.LAUNCHES == {"slstm_scan_fwd": 0}


def test_slstm_scan_matches_reference_at_head_dim_512():
    """The xlstm-1.3b head dim (4 MiB of ``r`` per head in f32) at a short
    sequence that is not a multiple of the block."""
    _compare((1, 3, 2, 512, 2, True))


def test_wrapper_on_cpu_equals_plain_version():
    g_in, r, b, st, _ = _inputs(2, 5, 2, 4, True)
    args = [torch.from_numpy(a) for a in (g_in, r, b)]
    states = [torch.from_numpy(st[k]) for k in STATE]
    got = t_kernel.slstm_scan_fwd(*args, *states)
    hs, fin = t_ref.slstm_scan_ref(*args, dict(zip(STATE, states)))
    for a, want in zip(got, [hs] + [fin[k] for k in STATE], strict=True):
        assert torch.equal(a, want)


def test_extreme_gates_stay_finite():
    """Gates of magnitude up to 100: the stable log-sigmoid and the m
    stabiliser keep every output finite, and the port agrees with the
    reference's plain version."""
    from repro.kernels.slstm_scan.ref import slstm_scan_ref as r_ref
    g_in, r, b, st, _ = _inputs(2, 16, 2, 8, True, seed=7)
    g_in = g_in * 200.0
    hs, fin = t_ref.slstm_scan_ref(*(torch.from_numpy(a) for a in
                                     (g_in, r, b)),
                                   {k: torch.from_numpy(v)
                                    for k, v in st.items()})
    r_hs, r_fin = r_ref(jnp.asarray(g_in), jnp.asarray(r), jnp.asarray(b),
                        {k: jnp.asarray(v) for k, v in st.items()})
    assert np.abs(g_in).max() > 90
    assert torch.isfinite(hs).all()
    np.testing.assert_allclose(hs.numpy(), np.asarray(r_hs), rtol=0,
                               atol=FWD_ATOL)
    for k in STATE:
        assert torch.isfinite(fin[k]).all()
        np.testing.assert_allclose(fin[k].numpy(), np.asarray(r_fin[k]),
                                   rtol=1e-6, atol=FWD_ATOL)
