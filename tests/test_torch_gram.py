"""The dense-Gram nHSIC of the port (K6 ``gram``, K7 ``gram_stats`` and
``ops.nhsic_unfused``) against the JAX reference.

The reference runs ``gram_pallas`` and ``gram_stats_pallas`` in interpret
mode, as its own tests do; the port's wrappers take their plain ``ref.py``
versions on CPU tensors.  Inputs come from numpy seeds.  Bars: max abs
1e-5 for the RBF Gram (the reference test's own), scale-relative 1e-5 for
the linear Gram, rtol 1e-4 for the centred statistics and abs 1e-4 for
nHSIC (both the reference tests' own).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hsic as r_hsic
from repro.kernels.hsic_gram import ops as r_ops
from repro.kernels.hsic_gram.kernel import gram_pallas, gram_stats_pallas
from repro_torch.core import hsic as t_hsic
from repro_torch.kernels.hsic_gram import kernel as t_kernel
from repro_torch.kernels.hsic_gram import ops as t_ops

# the draws of tests/test_kernel_hsic.py::test_gram_kernel_matches_ref,
# every (B, D) with the reference's block cycling through 8, 16, 128
GRAM_CASES = [(B, D, (8, 16, 128)[i % 3])
              for i, (B, D) in enumerate((B, D) for B in (8, 16, 32, 48)
                                         for D in (4, 16, 64, 200))]
LINEAR_CASES = [(8, 4, 8), (32, 64, 16), (48, 200, 128), (33, 7, 128)]
# (B, reference block, symmetric): B = 33 is off the port's 32-row tile
# and the reference shrinks its block to 11
STATS_CASES = [(8, 8, True), (16, 8, True), (64, 32, True), (64, 8, False),
               (33, 16, True), (33, 16, False)]
# (B, Dx, Dz, linear_x): the main paths' nHSIC calls (ResNet18 h_xz at the
# four stages and h_yz, ViT-12 h_xz and h_yz, xlstm-1.3b h_xz and h_yz)
MAIN_PATH_SHAPES = [(32, 3, 64, False), (32, 64, 128, False),
                    (32, 128, 256, False), (32, 256, 512, False),
                    (32, 10, 64, True), (32, 384, 384, False),
                    (32, 100, 64, True), (16, 2048, 2048, False),
                    (16, 256, 64, True)]


def _rng_x(B, D, seed):
    return np.random.default_rng(seed).standard_normal((B, D)).astype(
        np.float32)


@pytest.mark.parametrize("case", GRAM_CASES, ids=[f"B{b}-D{d}-block{k}"
                                                  for b, d, k in GRAM_CASES])
def test_rbf_gram_matches_reference_kernel(case):
    B, D, block = case
    x = _rng_x(B, D, B * D)
    s2 = float(jnp.mean(r_hsic.pairwise_sqdists(jnp.asarray(x))))
    want = np.asarray(gram_pallas(jnp.asarray(x), s2, block=block,
                                  interpret=True))
    got = t_kernel.gram(torch.from_numpy(x), s2).numpy()
    assert got.shape == (B, B) and got.dtype == np.float32
    assert float(np.max(np.abs(got - want))) < 1e-5


@pytest.mark.parametrize("case", LINEAR_CASES, ids=[f"B{b}-D{d}-block{k}"
                                                    for b, d, k in
                                                    LINEAR_CASES])
def test_linear_gram_matches_reference_kernel(case):
    B, D, block = case
    x = _rng_x(B, D, B + D)
    want = np.asarray(gram_pallas(jnp.asarray(x), 1.0, linear=True,
                                  block=block, interpret=True))
    got = t_kernel.gram(torch.from_numpy(x), torch.tensor(1.0),
                        linear=True).numpy()
    assert float(np.max(np.abs(got - want))) <= 1e-5 * float(
        np.max(np.abs(want)))


def test_gram_upcasts_half_precision_input():
    x = torch.from_numpy(_rng_x(16, 8, 3)).bfloat16()
    assert torch.equal(t_kernel.gram(x, 2.0), t_kernel.gram(x.float(), 2.0))


@pytest.mark.parametrize("case", STATS_CASES,
                         ids=[f"B{b}-block{k}-{'sym' if s else 'nonsym'}"
                              for b, k, s in STATS_CASES])
def test_gram_stats_match_reference_kernel(case):
    B, block, symmetric = case
    rng = np.random.default_rng(B * 10 + block)
    kx, kz = (rng.uniform(size=(B, B)).astype(np.float32) for _ in range(2))
    if symmetric:
        kx, kz = (kx + kx.T) / 2, (kz + kz.T) / 2
    want = gram_stats_pallas(jnp.asarray(kx), jnp.asarray(kz), block=block,
                             interpret=True)
    got = t_kernel.gram_stats(torch.from_numpy(kx), torch.from_numpy(kz))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def _nhsic_inputs(B, Dx, Dz, lx, degenerate=False):
    rng = np.random.default_rng(B * 1000 + Dx * 10 + Dz)
    if lx:
        x = np.eye(Dx, dtype=np.float32)[rng.integers(0, Dx, B)]
    else:
        x = rng.standard_normal((B, Dx)).astype(np.float32)
    z = rng.standard_normal((B, Dz)).astype(np.float32)
    if degenerate:
        x, z = np.repeat(x[:1], B, 0), np.repeat(z[:1], B, 0)
    return x, z


@pytest.mark.parametrize(
    "case", MAIN_PATH_SHAPES + [(32, 5, 8, False, True),
                                (48, 10, 64, True, True)],
    ids=[f"B{c[0]}-{c[1]}x{c[2]}-{'linear' if c[3] else 'rbf'}"
         f"{'-degenerate' if len(c) > 4 else ''}"
         for c in MAIN_PATH_SHAPES + [(32, 5, 8, False, True),
                                      (48, 10, 64, True, True)]])
def test_nhsic_unfused_matches_reference_and_fused_path(case):
    B, Dx, Dz, lx = case[:4]
    degenerate = len(case) > 4
    kx = "linear" if lx else "rbf"
    x, z = _nhsic_inputs(B, Dx, Dz, lx, degenerate)
    xt, zt = torch.from_numpy(x), torch.from_numpy(z)
    t_kernel.reset_launches()
    got = t_ops.nhsic_unfused(xt, zt, kernel_x=kx)
    assert got.shape == () and not got.requires_grad
    assert all(c == 0 for c in t_kernel.LAUNCHES.values())
    got = float(got)
    want = float(r_ops.nhsic_unfused(jnp.asarray(x), jnp.asarray(z),
                                     kernel_x=kx, interpret=True))
    fused = float(t_ops.nhsic(xt, zt, kernel_x=kx))
    plain = float(t_hsic.nhsic(xt, zt, kernel_x=kx))
    assert np.isfinite(got)
    for other in (want, fused, plain):
        assert abs(got - other) <= 1e-4
    if degenerate:
        assert got == 0.0
