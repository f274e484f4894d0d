"""The streaming nHSIC CUDA kernels against their plain versions, on the
card.  Marked ``cuda``: without a card every test here skips (the kernels
have no CPU mode).  On a machine with one:

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_kernels_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX, which a machine with
the card need not have.)

Bar: scale-relative 1e-3 in f32 (``analysis/pallas_audit.py``'s), TF32 off.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import hsic
from repro_torch.kernels.hsic_gram import kernel, ops, ref

pytestmark = pytest.mark.cuda
TOL = 1e-3

# (B, Dx, Dz, linear_x, degenerate): the main path's shapes, then batches
# and widths off the 32-row tile, then identical rows
CASES = [(32, 3, 64, False, False), (32, 64, 128, False, False),
         (32, 128, 256, False, False), (32, 256, 512, False, False),
         (32, 10, 64, True, False), (48, 1, 512, False, False),
         (256, 512, 1, True, False), (48, 7, 33, True, False),
         (32, 5, 8, False, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the nHSIC kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)


def _inputs(case, device):
    B, Dx, Dz, lx, degenerate = case
    rng = np.random.default_rng(B * 1000 + Dx)
    x = torch.from_numpy(rng.standard_normal((B, Dx)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((B, Dz)).astype(np.float32))
    if degenerate:
        x, z = x[:1].repeat(B, 1), z[:1].repeat(B, 1)
    return x.to(device), z.to(device)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_kernels_match_plain_versions(cuda, case):
    B, Dx, Dz, lx, _ = case
    x, z = _inputs(case, cuda)
    one = torch.ones((), device=cuda)
    s2 = torch.stack([one if lx else hsic.rbf_sigma2(x), hsic.rbf_sigma2(z)])
    kernel.reset_launches()
    rk = kernel.nhsic_rowsums(x, z, s2, linear_x=lx)
    rr = ref.nhsic_rowsums(x, z, s2, linear_x=lx)
    assert _rel(rk[0], rr[0]) <= TOL and _rel(rk[1], rr[1]) <= TOL
    rx, rz = rr[0] / B, rr[1] / B
    s = torch.cat([s2, torch.stack([rr[0].sum(), rr[1].sum()]) / (B * B)])
    sk = kernel.nhsic_stats_feats(x, z, rx, rz, s, linear_x=lx)
    assert _rel(sk, ref.nhsic_stats_feats(x, z, rx, rz, s,
                                          linear_x=lx)) <= TOL
    scal = torch.cat([s, torch.tensor([0.7, 0.3, -0.2], device=cuda)])
    gk = kernel.nhsic_grad(x, z, rx, rz, scal, linear_x=lx)
    gr = ref.nhsic_grad(x, z, rx, rz, scal, linear_x=lx)
    assert _rel(gk[0], gr[0]) <= TOL and _rel(gk[1], gr[1]) <= TOL
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == {"nhsic_rowsums": 1, "nhsic_stats_feats": 1,
                               "nhsic_grad": 1}


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_autograd_matches_plain_nhsic(cuda, case):
    lx = case[3]
    x, z = _inputs(case, cuda)
    kx = "linear" if lx else "rbf"
    xa, za = x.clone().requires_grad_(), z.clone().requires_grad_()
    v = ops.nhsic(xa, za, kernel_x=kx)
    v.backward()
    xb, zb = x.clone().requires_grad_(), z.clone().requires_grad_()
    vb = hsic.nhsic(xb, zb, kernel_x=kx)
    vb.backward()
    v, vb = float(v.detach()), float(vb.detach())
    assert abs(v - vb) <= TOL * max(abs(vb), 1e-6)
    assert _rel(xa.grad, xb.grad) <= TOL and _rel(za.grad, zb.grad) <= TOL
    assert torch.isfinite(xa.grad).all() and torch.isfinite(za.grad).all()


def test_statistics_are_the_same_from_run_to_run(cuda):
    x, z = _inputs((256, 64, 128, False, False), cuda)
    runs = [ops.nhsic(x, z) for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs)


def test_wrappers_raise_on_bad_inputs(cuda):
    x, z = _inputs((32, 3, 64, False, False), cuda)
    s2 = torch.ones(2, device=cuda)
    with pytest.raises(ValueError, match="is on"):
        kernel.nhsic_rowsums(x, z.cpu(), s2)
    with pytest.raises(ValueError, match="dtype"):
        kernel.nhsic_rowsums(x.double(), z.double(), s2.double())
    with pytest.raises(ValueError, match="contiguous"):
        kernel.nhsic_rowsums(x.t().contiguous().t(), z, s2)
