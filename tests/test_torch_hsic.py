"""nHSIC of the port against the JAX reference, value and gradient.

The reference runs its streaming Pallas kernels in interpret mode, as its
own tests do; the port runs ``kernels.hsic_gram.ops.nhsic``, whose wrappers
take the plain ``ref.py`` versions on CPU tensors.  Shapes are the main
path's (B=32; h_xz RBF×RBF at the four ResNet18 stage widths, h_yz
linear×RBF on one-hot labels), a batch that is not a multiple of the 32-row
tile, and a degenerate batch of identical rows.  Bar: scale-relative 1e-3
in f32, the reference kernel fuzzer's (``analysis/pallas_audit.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hsic as r_hsic
from repro.kernels.hsic_gram import kernel as r_kernel
from repro.kernels.hsic_gram import ops as r_ops
from repro_torch.core import hsic as t_hsic
from repro_torch.kernels.hsic_gram import kernel as t_kernel
from repro_torch.kernels.hsic_gram import ops as t_ops
from repro_torch.kernels.hsic_gram import ref as t_ref

TOL = 1e-3

# (B, Dx, Dz, kernel_x, degenerate)
CASES = [
    (32, 3, 64, "rbf", False),      # stage 0: pooled image vs 64 channels
    (32, 64, 128, "rbf", False),
    (32, 128, 256, "rbf", False),
    (32, 256, 512, "rbf", False),
    (32, 10, 64, "linear", False),  # h_yz: one-hot labels vs projector
    (48, 7, 33, "rbf", False),      # B and D off the 32 tile
    (48, 10, 64, "linear", False),
    (32, 5, 8, "rbf", True),        # identical rows: nHSIC 0, grads 0
]
IDS = [f"B{b}-{dx}x{dz}-{k}{'-degenerate' if d else ''}"
       for b, dx, dz, k, d in CASES]


def _rel_err(a, b):
    """max |a−b| / max |b|, floored as in the reference kernel fuzzer."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-6))


def _inputs(B, Dx, Dz, kernel_x, degenerate, seed=0):
    rng = np.random.default_rng(seed)
    if kernel_x == "linear":
        x = np.eye(Dx, dtype=np.float32)[rng.integers(0, Dx, B)]
    else:
        x = rng.standard_normal((B, Dx)).astype(np.float32)
    z = rng.standard_normal((B, Dz)).astype(np.float32)
    if degenerate:
        x = np.repeat(x[:1], B, 0)
        z = np.repeat(z[:1], B, 0)
    return x, z


def _port(fn, x, z):
    xt = torch.from_numpy(x).requires_grad_(True)
    zt = torch.from_numpy(z).requires_grad_(True)
    v = fn(xt, zt)
    v.backward()
    return v.detach().numpy(), xt.grad.numpy(), zt.grad.numpy()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_nhsic_value_and_grad_match_reference_kernel(case):
    B, Dx, Dz, kx, degenerate = case
    x, z = _inputs(*case)
    ref_fn = lambda a, b: r_ops.nhsic(a, b, kernel_x=kx, interpret=True)
    r_val, (r_dx, r_dz) = jax.value_and_grad(ref_fn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(z))
    t_val, t_dx, t_dz = _port(
        lambda a, b: t_ops.nhsic(a, b, kernel_x=kx), x, z)
    for got, want in ((t_val, r_val), (t_dx, r_dx), (t_dz, r_dz)):
        assert np.all(np.isfinite(got))
        assert _rel_err(got, want) <= TOL
    if degenerate:
        assert float(t_val) == 0.0
        assert not t_dx.any() and not t_dz.any()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_path_matches_plain_nhsic(case):
    """The port's ops.nhsic (closed-form backward) against autograd of its
    plain core/hsic.nhsic: values at 1e-5, grads at the kernel bar."""
    B, Dx, Dz, kx, _ = case
    x, z = _inputs(*case)
    k_val, k_dx, k_dz = _port(
        lambda a, b: t_ops.nhsic(a, b, kernel_x=kx), x, z)
    p_val, p_dx, p_dz = _port(
        lambda a, b: t_hsic.nhsic(a, b, kernel_x=kx), x, z)
    assert abs(float(k_val) - float(p_val)) <= 1e-5
    assert _rel_err(k_dx, p_dx) <= TOL and _rel_err(k_dz, p_dz) <= TOL


@pytest.mark.parametrize("case", CASES[:1] + CASES[4:7],
                         ids=IDS[:1] + IDS[4:7])
def test_ref_versions_match_the_pallas_kernels(case):
    """ref.py, which the CUDA kernels are held against on the card,
    computes what each TPU kernel computes (same inputs, interpret mode)."""
    B, Dx, Dz, kx, _ = case
    lx = kx == "linear"
    x, z = _inputs(*case)
    xj, zj = jnp.asarray(x), jnp.asarray(z)
    xt, zt = torch.from_numpy(x), torch.from_numpy(z)
    s2x = 1.0 if lx else float(r_hsic.rbf_sigma2(xj))
    s2z = float(r_hsic.rbf_sigma2(zj))
    rxs, rzs = r_kernel.nhsic_rowsums_pallas(xj, zj, s2x, s2z, linear_x=lx,
                                             interpret=True)
    trx, trz = t_ref.nhsic_rowsums(xt, zt, torch.tensor([s2x, s2z]),
                                   linear_x=lx)
    assert _rel_err(trx, rxs) <= TOL and _rel_err(trz, rzs) <= TOL
    rx, rz = np.asarray(rxs) / B, np.asarray(rzs) / B
    mx, mz = float(np.sum(rxs)) / B / B, float(np.sum(rzs)) / B / B
    stats = r_kernel.nhsic_stats_feats_pallas(
        xj, zj, jnp.asarray(rx), jnp.asarray(rz), mx, mz, s2x, s2z,
        linear_x=lx, interpret=True)
    s = torch.tensor([s2x, s2z, mx, mz])
    t_stats = t_ref.nhsic_stats_feats(xt, zt, torch.from_numpy(rx),
                                      torch.from_numpy(rz), s, linear_x=lx)
    assert _rel_err(t_stats, np.stack([np.asarray(v) for v in stats])) <= TOL
    scal = np.asarray([s2x, s2z, mx, mz, 0.7, 0.3, -0.2], np.float32)
    dx, dz = r_kernel.nhsic_grad_pallas(xj, zj, jnp.asarray(rx),
                                        jnp.asarray(rz), jnp.asarray(scal),
                                        linear_x=lx, interpret=True)
    tdx, tdz = t_ref.nhsic_grad(xt, zt, torch.from_numpy(rx),
                                torch.from_numpy(rz), torch.from_numpy(scal),
                                linear_x=lx)
    assert _rel_err(tdx, dx) <= TOL and _rel_err(tdz, dz) <= TOL


def test_residuals_are_order_b_times_d():
    x, z = _inputs(64, 16, 32, "rbf", False)
    _, res = t_ops.nhsic_residuals(torch.from_numpy(x), torch.from_numpy(z))
    assert max(r.numel() for r in res) == 64 * 32
    assert t_kernel.LAUNCHES == {"nhsic_rowsums": 0, "nhsic_stats_feats": 0,
                                 "nhsic_grad": 0, "gram": 0, "gram_stats": 0}


def test_features_and_bandwidth_match_reference():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((16, 4, 4, 8)).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    np.testing.assert_allclose(
        t_hsic.pool_features(torch.from_numpy(a)).numpy(),
        np.asarray(r_hsic.pool_features(jnp.asarray(a))), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        t_hsic.label_features(torch.from_numpy(labels), 10).numpy(),
        np.asarray(r_hsic.label_features(jnp.asarray(labels), 10)),
        rtol=1e-6)
    x = rng.standard_normal((32, 24)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    s = t_hsic.rbf_sigma2(xt)
    assert not s.requires_grad
    np.testing.assert_allclose(float(s), float(r_hsic.rbf_sigma2(
        jnp.asarray(x))), rtol=1e-6)
