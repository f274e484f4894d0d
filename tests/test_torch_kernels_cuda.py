"""The CUDA kernels (streaming nHSIC, flash-attention forward, sLSTM scan)
against their plain versions, on the card.  Marked ``cuda``: without a card every
test here skips (the kernels have no CPU mode).  On a machine with one:

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_kernels_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX, which a machine with
the card need not have.)

Bar: scale-relative 1e-3 in f32 and 2e-2 in bf16
(``analysis/pallas_audit.py``'s), TF32 off.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import hsic
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.hsic_gram import kernel, ops, ref
from repro_torch.kernels.slstm_scan import kernel as sl_kernel
from repro_torch.kernels.slstm_scan import ops as sl_ops
from repro_torch.kernels.slstm_scan import ref as sl_ref

pytestmark = pytest.mark.cuda
TOL = 1e-3

# (B, Dx, Dz, linear_x, degenerate): the main paths' shapes (ResNet18,
# then xlstm-1.3b's h_xz and h_yz), then batches and widths off the 32-row
# tile, then identical rows
CASES = [(32, 3, 64, False, False), (32, 64, 128, False, False),
         (32, 128, 256, False, False), (32, 256, 512, False, False),
         (32, 10, 64, True, False), (16, 2048, 2048, False, False),
         (16, 256, 64, True, False), (48, 1, 512, False, False),
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


# (B, Sq, Skv, H, KV, D, causal, window, dtype): the ViT-12 shape, the
# reference's AUDIT_CASES (bf16, ragged S=200, windowed), GQA, causal with
# Sq != Skv, and causal+window with rows that have no allowed key
FLASH_CASES = [
    (32, 64, 64, 6, 6, 64, False, 0, "float32"),
    (2, 1024, 1024, 2, 2, 64, True, 0, "float32"),
    (2, 512, 512, 2, 2, 64, True, 0, "bfloat16"),
    (1, 200, 200, 2, 2, 64, True, 0, "float32"),
    (1, 512, 512, 1, 1, 32, False, 64, "float32"),
    (2, 96, 96, 4, 2, 64, True, 0, "float32"),
    (2, 70, 150, 4, 2, 64, True, 0, "float32"),
    (2, 150, 70, 4, 4, 32, True, 0, "float32"),
    (1, 41, 14, 2, 2, 16, True, 4, "float32"),
    (2, 130, 100, 4, 2, 128, True, 7, "float32"),
]


def _flash_inputs(case, device):
    B, Sq, Skv, H, KV, D, _, _, dtype = case
    rng = np.random.default_rng(Sq * 1000 + Skv)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(device, dt) for s in [(B, Sq, H, D), (B, Skv, KV, D),
                                         (B, Skv, KV, D)])
    return q, k, v


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[str(c) for c in FLASH_CASES])
def test_flash_kernel_matches_plain_version(cuda, case):
    causal, window, dtype = case[6], case[7], case[8]
    q, k, v = _flash_inputs(case, cuda)
    fa_kernel.reset_launches()
    got = fa_kernel.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window)
    want = fa_ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    assert fa_kernel.LAUNCHES == {"flash_attention_fwd": 1}
    tol = TOL if dtype == "float32" else 2e-2
    assert _rel(got.float(), want.float()) <= tol
    mask = fa_ref.attention_mask(case[1], case[2], causal, window, cuda)
    empty = ~mask.any(dim=1)
    assert bool((got[:, empty] == 0).all())


@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[5],
                                  FLASH_CASES[8]],
                         ids=[str(c) for c in (FLASH_CASES[0], FLASH_CASES[5],
                                               FLASH_CASES[8])])
def test_flash_autograd_matches_plain_path(cuda, case):
    causal, window = case[6], case[7]
    q, k, v = _flash_inputs(case, cuda)
    g = torch.randn(q.shape, device=cuda, generator=torch.Generator(
        cuda).manual_seed(0))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    fa_ops.flash_attention(*a, causal=causal, window=window).backward(g)
    fa_ref.attention_ref(*b, causal=causal, window=window).backward(g)
    for x, y in zip(a, b):
        assert _rel(x.grad, y.grad) <= TOL
        assert torch.isfinite(x.grad).all()


def test_flash_wrapper_raises_on_bad_inputs(cuda):
    q, k, v = _flash_inputs(FLASH_CASES[5], cuda)
    with pytest.raises(ValueError, match="is on"):
        fa_kernel.flash_attention_fwd(q, k.cpu(), v, causal=True)
    with pytest.raises(ValueError, match="dtype"):
        fa_kernel.flash_attention_fwd(q.double(), k.double(), v.double(),
                                      causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        fa_kernel.flash_attention_fwd(q.transpose(1, 2), k, v, causal=True)


# (B, S, H, Dh, random_state0, gate_scale): the xlstm-1.3b shape, the
# reference's audit shapes (kernels/slstm_scan/ops.py), S=1, S=200 (ragged
# against the reference's 128-step blocks), head dims 1, 3 and 48, random
# non-zero initial states, and gates up to |g| = 100
SLSTM_CASES = [
    (16, 256, 4, 512, False, 1.0),
    (2, 256, 2, 512, False, 1.0),
    (2, 128, 4, 64, False, 1.0),
    (2, 1, 4, 64, True, 1.0),
    (2, 200, 2, 64, False, 1.0),
    (3, 37, 3, 1, True, 1.0),
    (3, 37, 3, 3, True, 1.0),
    (2, 37, 2, 48, True, 1.0),
    (2, 64, 2, 128, True, 100.0),
]
STATE = ("c", "n", "m", "h")


def _slstm_inputs(case, device):
    B, S, H, Dh, random_state0, scale = case
    rng = np.random.default_rng(B * 1000 + S * 10 + Dh)
    f = np.float32
    if scale > 1:
        g_in = rng.uniform(-scale, scale, (B, S, 4, H, Dh))
    else:
        g_in = rng.standard_normal((B, S, 4, H, Dh))
    r = rng.standard_normal((4, H, Dh, Dh)) * (0.5 / np.sqrt(Dh))
    b = rng.standard_normal((4, H, Dh)) * 0.1
    if random_state0:
        st = [rng.standard_normal((B, H, Dh)),
              np.abs(rng.standard_normal((B, H, Dh))) + 0.1,
              rng.standard_normal((B, H, Dh)),
              rng.standard_normal((B, H, Dh)) * 0.5]
    else:
        z = np.zeros((B, H, Dh))
        st = [z, z, z - 30.0, z]
    return [torch.from_numpy(a.astype(f)).to(device)
            for a in (g_in, r, b, *st)]


@pytest.mark.parametrize("case", SLSTM_CASES,
                         ids=[str(c) for c in SLSTM_CASES])
def test_slstm_kernel_matches_plain_version(cuda, case):
    g_in, r, b, *st = _slstm_inputs(case, cuda)
    sl_kernel.reset_launches()
    got = sl_kernel.slstm_scan_fwd(g_in, r, b, *st)
    hs, fin = sl_ref.slstm_scan_ref(g_in, r, b, dict(zip(STATE, st)))
    torch.cuda.synchronize()
    assert sl_kernel.LAUNCHES == {"slstm_scan_fwd": 1}
    assert got[0].shape == hs.shape
    for a, want in zip(got, [hs] + [fin[k] for k in STATE], strict=True):
        assert torch.isfinite(a).all()
        assert _rel(a, want) <= TOL


@pytest.mark.parametrize("case", [SLSTM_CASES[2], SLSTM_CASES[7]],
                         ids=[str(c) for c in (SLSTM_CASES[2],
                                               SLSTM_CASES[7])])
def test_slstm_autograd_matches_plain_path(cuda, case):
    inputs = _slstm_inputs(case, cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    cot = [torch.randn(inputs[0].shape[:2] + inputs[0].shape[3:],
                       device=cuda, generator=gen)] + [
        torch.randn(inputs[3].shape, device=cuda, generator=gen)
        for _ in STATE]
    a = [t.clone().requires_grad_() for t in inputs]
    b = [t.clone().requires_grad_() for t in inputs]
    hs, fin = sl_ops.slstm_scan(*a[:3], dict(zip(STATE, a[3:])))
    torch.autograd.backward([hs] + [fin[k] for k in STATE], cot)
    hs_p, fin_p = sl_ref.slstm_scan_ref(*b[:3], dict(zip(STATE, b[3:])))
    torch.autograd.backward([hs_p] + [fin_p[k] for k in STATE], cot)
    for x, y in zip(a, b, strict=True):
        assert torch.isfinite(x.grad).all()
        assert _rel(x.grad, y.grad) <= TOL


def test_slstm_wrapper_raises_on_bad_inputs(cuda):
    g_in, r, b, *st = _slstm_inputs(SLSTM_CASES[7], cuda)
    with pytest.raises(ValueError, match="is on"):
        sl_kernel.slstm_scan_fwd(g_in, r.cpu(), b, *st)
    with pytest.raises(ValueError, match="dtype"):
        sl_kernel.slstm_scan_fwd(g_in.double(), r.double(), b.double(),
                                 *(t.double() for t in st))
    with pytest.raises(ValueError, match="must be"):
        sl_kernel.slstm_scan_fwd(g_in, r[:, :1], b, *st)
    with pytest.raises(ValueError, match="contiguous"):
        sl_kernel.slstm_scan_fwd(g_in, r.transpose(2, 3), b, *st)
    big = sl_kernel.MAX_HEAD_DIM + 1
    z = torch.zeros(1, 1, big, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        sl_kernel.slstm_scan_fwd(torch.zeros(1, 2, 4, 1, big, device=cuda),
                                 torch.zeros(4, 1, big, big, device=cuda),
                                 torch.zeros(4, 1, big, device=cuda),
                                 z, z, z, z)
