"""The CUDA kernels (streaming and dense-Gram nHSIC, flash-attention
forward, sLSTM scan forward and backward) against their plain versions,
and the ResNet path's rounds against themselves, on the card.  Marked
``cuda``: without a card every test here skips (the kernels have no CPU
mode).  On a machine with one:

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
         (32, 5, 8, False, True),
         # the edges of K2's and K3's clusters (4 to 16 ranks, about 64
         # columns of the wider side a rank, each owning a slice of D in
         # multiples of 4, at most 256 columns at once): D = 1 and D < C
         # (trailing ranks own nothing), D off a multiple of 4 or of the
         # slice, D = 4096, D above 16 x 256 (the slices taken in
         # segments); B = 1, 16, 33, 48, 256.  B = 1 with
         # an RBF z of one column: a single row's mean-distance bandwidth
         # clamps to 1e-8, and over more columns the plain version's own
         # rounding then turns the diagonal of 1 into 0 (identical rows
         # below take B = 1 with seven)
         (1, 5, 1, True, False), (16, 4096, 100, False, False),
         (33, 10, 4096, True, False), (48, 100, 33, True, False),
         (256, 1, 4096, False, False), (33, 4100, 3, False, False),
         (48, 8192, 64, False, False), (16, 3, 5, False, False)]


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
                               "nhsic_grad": 1, "gram": 0, "gram_stats": 0}


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


def _kernel_args(x, z, lx=False):
    """K2's and K3's inputs as the nHSIC forward and backward build them,
    the row sums from K1."""
    B = x.shape[0]
    one = torch.ones((), device=x.device)
    s2 = torch.stack([one if lx else hsic.rbf_sigma2(x), hsic.rbf_sigma2(z)])
    rxs, rzs = kernel.nhsic_rowsums(x, z, s2, linear_x=lx)
    s = torch.cat([s2, torch.stack([rxs.sum(), rzs.sum()]) / (B * B)])
    scal = torch.cat([s, torch.tensor([0.7, 0.3, -0.2], device=x.device)])
    return rxs / B, rzs / B, s, scal


REPEAT_CASES = [(256, 64, 128, False, False), (32, 256, 512, False, False),
                (16, 2048, 2048, False, False), (48, 8192, 64, False, False)]


@pytest.mark.parametrize("case", REPEAT_CASES,
                         ids=[str(c) for c in REPEAT_CASES])
def test_stats_and_grad_kernels_repeat_their_bits(cuda, case):
    x, z = _inputs(case, cuda)
    rx, rz, s, scal = _kernel_args(x, z)
    stats = [kernel.nhsic_stats_feats(x, z, rx, rz, s) for _ in range(3)]
    grads = [kernel.nhsic_grad(x, z, rx, rz, scal) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, stats[0]) for a in stats)
    assert all(torch.equal(a, b) for g in grads for a, b in zip(g, grads[0]))


IDENTICAL_CASES = [(32, 5, 8, False, True), (16, 2048, 2048, False, True),
                   (33, 4100, 3, False, True), (256, 64, 1, False, True),
                   (1, 1, 7, False, True)]


@pytest.mark.parametrize("case", IDENTICAL_CASES,
                         ids=[str(c) for c in IDENTICAL_CASES])
def test_identical_rows_give_exact_zeros(cuda, case):
    """Identical rows, RBF on both sides: K1's row sums are exactly B, so
    every centred Gram entry is exactly 0, and so must be K2's statistics,
    K3's gradients and the op's value and gradients."""
    x, z = _inputs(case, cuda)
    rx, rz, s, scal = _kernel_args(x, z)
    assert torch.equal(rx, torch.ones_like(rx))
    assert (kernel.nhsic_stats_feats(x, z, rx, rz, s) == 0).all()
    gx, gz = kernel.nhsic_grad(x, z, rx, rz, scal)
    assert (gx == 0).all() and (gz == 0).all()
    xa, za = x.clone().requires_grad_(), z.clone().requires_grad_()
    v = ops.nhsic(xa, za)
    v.backward()
    assert float(v.detach()) == 0.0
    for g in (xa.grad, za.grad):
        assert torch.isfinite(g).all() and (g == 0).all()


def test_wrappers_raise_on_bad_inputs(cuda):
    x, z = _inputs((32, 3, 64, False, False), cuda)
    s2 = torch.ones(2, device=cuda)
    with pytest.raises(ValueError, match="is on"):
        kernel.nhsic_rowsums(x, z.cpu(), s2)
    with pytest.raises(ValueError, match="dtype"):
        kernel.nhsic_rowsums(x.double(), z.double(), s2.double())
    with pytest.raises(ValueError, match="contiguous"):
        kernel.nhsic_rowsums(x.t().contiguous().t(), z, s2)


# (B, D): the reference's audit shape (ops.AUDIT_CASES), the draws of its
# gram test, the main paths' activation and label widths, ragged B
# (1, 33, 200) and D = 1
GRAM_CASES = [(256, 256), (8, 4), (16, 16), (32, 64), (48, 200), (32, 3),
              (32, 512), (32, 384), (16, 2048), (16, 256), (1, 5), (33, 7),
              (200, 64), (64, 1)]


def _gram_input(B, D, device, linear):
    rng = np.random.default_rng(B * 100 + D)
    if linear:
        x = np.eye(D, dtype=np.float32)[rng.integers(0, D, B)]
    else:
        x = rng.standard_normal((B, D)).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("linear", [False, True], ids=["rbf", "linear"])
@pytest.mark.parametrize("case", GRAM_CASES, ids=[str(c) for c in GRAM_CASES])
def test_gram_kernel_matches_plain_version(cuda, case, linear):
    x = _gram_input(*case, cuda, linear)
    s2 = torch.ones((), device=cuda) if linear else hsic.rbf_sigma2(x)
    kernel.reset_launches()
    got = kernel.gram(x, s2, linear=linear)
    want = ref.gram(x, s2, linear)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["gram"] == 1
    assert got.shape == (case[0], case[0]) and got.dtype == torch.float32
    assert _rel(got, want) <= TOL
    assert torch.equal(got, got.T)
    if not linear:
        assert bool((got.diagonal() == 1).all())


# K6's tiling: B off the 32-row tile on both sides (1, 31, 33, 257) against
# D off its 16-column chunks and its eight warp slices (1, 7, 257, 2048)
GRAM_TILING = [(B, D) for B in (1, 31, 33, 257) for D in (1, 7, 257, 2048)]


@pytest.mark.parametrize("linear", [False, True], ids=["rbf", "linear"])
@pytest.mark.parametrize("case", GRAM_TILING,
                         ids=[str(c) for c in GRAM_TILING])
def test_gram_kernel_tiling_is_exact_and_symmetric(cuda, case, linear):
    # sigma^2 = D, about half the squared distance of two unit-normal rows:
    # the mean-distance bandwidth of a single row is 0 (clamped to 1e-8),
    # where the plain version's own rounding of |a|^2 + |a|^2 - 2 a.a
    # turns its diagonal of 1 into 0
    x = _gram_input(*case, cuda, False)
    s2 = torch.full((), float(1 if linear else case[1]), device=cuda)
    got = kernel.gram(x, s2, linear=linear)
    torch.cuda.synchronize()
    assert _rel(got, ref.gram(x, s2, linear)) <= TOL
    assert torch.equal(got, got.T)
    if not linear:
        assert bool((got.diagonal() == 1).all())


@pytest.mark.parametrize("case", [(257, 7), (33, 2048), (64, 1)],
                         ids=["257x7", "33x2048", "64x1"])
def test_gram_kernel_identical_rows_give_exactly_one(cuda, case):
    """Identical rows in different tiles: their distance is exactly 0
    only if every tile sums norms and dots in the same order."""
    B, D = case
    x = _gram_input(1, D, cuda, False).repeat(B, 1).contiguous()
    got = kernel.gram(x, hsic.rbf_sigma2(x) + 1.0)
    assert bool((got == 1).all())


def test_gram_kernel_is_the_same_from_run_to_run(cuda):
    x = _gram_input(257, 257, cuda, False)
    s2 = hsic.rbf_sigma2(x)
    for linear in (False, True):
        runs = [kernel.gram(x, s2, linear=linear) for _ in range(3)]
        assert all(torch.equal(r, runs[0]) for r in runs)


def test_gram_kernel_upcasts_bf16(cuda):
    x = _gram_input(48, 200, cuda, False).bfloat16()
    assert torch.equal(kernel.gram(x, 3.0), kernel.gram(x.float(), 3.0))


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nonsym"])
@pytest.mark.parametrize("B", [256, 32, 16, 1, 33, 200])
def test_gram_stats_kernel_matches_plain_version(cuda, B, symmetric):
    rng = np.random.default_rng(B)
    kx, kz = (torch.from_numpy(rng.uniform(size=(B, B)).astype(np.float32))
              .to(cuda) for _ in range(2))
    if symmetric:
        kx, kz = (kx + kx.T) / 2, (kz + kz.T) / 2
    kernel.reset_launches()
    got = kernel.gram_stats(kx, kz)
    want = ref.gram_stats(kx, kz)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["gram_stats"] == 1
    # each of the three sums against its own plain value: the trace term
    # is about 1/B of the norms, so a bar scaled by the largest would miss it
    assert float(((got - want).abs() / want.abs().clamp_min(1e-6)).max()) \
        <= TOL


def test_gram_stats_are_the_same_from_run_to_run(cuda):
    x = _gram_input(256, 256, cuda, False)
    kx = kernel.gram(x, hsic.rbf_sigma2(x))
    kz = kernel.gram(x[:, :64].contiguous(), 1.0, linear=True)
    runs = [kernel.gram_stats(kx, kz) for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_nhsic_unfused_matches_fused_and_plain(cuda, case):
    x, z = _inputs(case, cuda)
    kx = "linear" if case[3] else "rbf"
    kernel.reset_launches()
    got = float(ops.nhsic_unfused(x, z, kernel_x=kx))
    assert kernel.LAUNCHES["gram"] == 2
    assert kernel.LAUNCHES["gram_stats"] == 1
    assert abs(got - float(ops.nhsic(x, z, kernel_x=kx))) <= 1e-4
    assert abs(got - float(hsic.nhsic(x, z, kernel_x=kx))) <= 1e-4


def test_gram_wrappers_raise_on_bad_inputs(cuda):
    x = _gram_input(32, 8, cuda, False)
    k = kernel.gram(x, 1.0)
    with pytest.raises(ValueError, match="dtype"):
        kernel.gram(x.double(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.gram(x.t().contiguous().t(), 1.0)
    with pytest.raises(ValueError, match="must be"):
        kernel.gram(x[None], 1.0)
    with pytest.raises(ValueError, match="one value"):
        kernel.gram(x, torch.ones(2, device=cuda))
    with pytest.raises(ValueError, match="is on"):
        kernel.gram_stats(k, k.cpu())
    with pytest.raises(ValueError, match="must be"):
        kernel.gram_stats(k, k[:, :16].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        kernel.gram_stats(k.double(), k.double())


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


# K4's tiling: head dims off the MMA's k of 8 (1, 3, 20, 100), fewer query
# rows than one warp's 16, several 32-row kv tiles with a ragged tail under
# causal + window
FLASH_TILING = [
    (2, 70, 90, 4, 2, 1, True, 0, "float32"),
    (2, 70, 90, 4, 2, 3, False, 0, "float32"),
    (2, 70, 90, 4, 2, 20, True, 0, "float32"),
    (2, 70, 90, 4, 2, 100, False, 0, "float32"),
    (2, 5, 40, 2, 2, 64, False, 0, "float32"),
    (3, 9, 9, 2, 1, 32, True, 0, "float32"),
    (1, 1000, 1000, 2, 2, 64, True, 300, "float32"),
    (1, 1000, 1000, 2, 2, 20, True, 300, "bfloat16"),
]


def _flash_inputs(case, device):
    B, Sq, Skv, H, KV, D, _, _, dtype = case
    rng = np.random.default_rng(Sq * 1000 + Skv)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(device, dt) for s in [(B, Sq, H, D), (B, Skv, KV, D),
                                         (B, Skv, KV, D)])
    return q, k, v


@pytest.mark.parametrize("case", FLASH_CASES + FLASH_TILING,
                         ids=[str(c) for c in FLASH_CASES + FLASH_TILING])
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


def test_flash_kernel_is_the_same_from_run_to_run(cuda):
    for case in (FLASH_CASES[0], FLASH_TILING[6]):
        q, k, v = _flash_inputs(case, cuda)
        runs = [fa_kernel.flash_attention_fwd(q, k, v, causal=case[6],
                                              window=case[7])
                for _ in range(3)]
        assert all(torch.equal(r, runs[0]) for r in runs)


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
# non-zero initial states, gates up to |g| = 100, B = 64 (four row chunks),
# H = 8 (past the blocks the card holds at once with r resident: r
# streams), Dh = 1024 at H = 16 (r's slice exceeds shared memory; a block
# owns several column tiles) and H = 1100 (more heads than blocks fit at
# once: the heads go in several launches)
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
    (64, 64, 4, 512, True, 1.0),
    (16, 64, 8, 512, True, 1.0),
    (2, 16, 16, 1024, True, 1.0),
    (2, 5, 1100, 2, True, 1.0),
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
    assert sl_kernel.LAUNCHES == {"slstm_scan_fwd": 1, "slstm_scan_bwd": 0}
    assert got[0].shape == hs.shape
    for a, want in zip(got, [hs] + [fin[k] for k in STATE], strict=True):
        assert torch.isfinite(a).all()
        assert _rel(a, want) <= TOL


def _slstm_cotangents(inputs, device):
    gen = torch.Generator(device).manual_seed(0)
    B, S, _, H, Dh = inputs[0].shape
    return [torch.randn((B, S, H, Dh), device=device, generator=gen)] + [
        torch.randn((B, H, Dh), device=device, generator=gen) for _ in STATE]


@pytest.mark.parametrize("case", SLSTM_CASES,
                         ids=[str(c) for c in SLSTM_CASES])
def test_slstm_saved_states_and_backward_kernel_match_plain_versions(cuda,
                                                                     case):
    """The forward's saved pre-activations and states against the plain
    scan's; the backward kernel, on those states, against
    ``slstm_scan_bwd_ref`` on the same inputs."""
    inputs = _slstm_inputs(case, cuda)
    g_in, r, b, *st = inputs
    sl_kernel.reset_launches()
    got = sl_kernel.slstm_scan_fwd(*inputs, save=True)
    _, _, saved = sl_ref.slstm_scan_ref(g_in, r, b, dict(zip(STATE, st)),
                                        save=True)
    for a, want in zip(got[5:], [saved[k] for k in "gcnm"], strict=True):
        assert _rel(a, want) <= TOL
    args = [*got[5:], r, *st[:3], *_slstm_cotangents(inputs, cuda)]
    dgot = sl_kernel.slstm_scan_bwd(*args)
    dwant = sl_ref.slstm_scan_bwd_ref(*args)
    torch.cuda.synchronize()
    assert sl_kernel.LAUNCHES == {"slstm_scan_fwd": 1, "slstm_scan_bwd": 1}
    for a, want in zip(dgot, dwant, strict=True):
        assert torch.isfinite(a).all()
        assert _rel(a, want) <= TOL


def test_slstm_kernels_are_the_same_from_run_to_run(cuda):
    inputs = _slstm_inputs(SLSTM_CASES[0], cuda)
    cot = _slstm_cotangents(inputs, cuda)
    runs = []
    for _ in range(3):
        out = sl_kernel.slstm_scan_fwd(*inputs, save=True)
        runs.append(out + sl_kernel.slstm_scan_bwd(*out[5:], inputs[1],
                                                   *inputs[3:6], *cot))
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


def test_slstm_backward_kernel_splits_a_tie_of_the_stabiliser(cuda):
    """g_i = log sigmoid(g_f) + m_0 exactly: g_f = 30 (log sigmoid is
    -9.4e-14 on any rounding) and m_0 = g_i = 1 tie in f32; r = 0 and
    b = 0, one step.  The kernel splits the final m's cotangent half and
    half between g_i and g_f, as autograd of the plain scan does."""
    B, H, Dh = 2, 2, 32
    g_in = torch.randn((B, 1, 4, H, Dh), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(1))
    g_in[:, 0, 0] = 1.0
    g_in[:, 0, 1] = 30.0
    r = torch.zeros((4, H, Dh, Dh), device=cuda)
    b = torch.zeros((4, H, Dh), device=cuda)
    st = [torch.full((B, H, Dh), v, device=cuda) for v in (0.5, 1.0, 1.0,
                                                            0.0)]
    cot = _slstm_cotangents([g_in], cuda)
    a = [t.clone().requires_grad_() for t in (g_in, r, b, *st)]
    p = [t.clone().requires_grad_() for t in (g_in, r, b, *st)]
    hs, fin = sl_ops.slstm_scan(*a[:3], dict(zip(STATE, a[3:])))
    torch.autograd.backward([hs] + [fin[k] for k in STATE], cot)
    hs_p, fin_p = sl_ref.slstm_scan_ref(*p[:3], dict(zip(STATE, p[3:])))
    torch.autograd.backward([hs_p] + [fin_p[k] for k in STATE], cot)
    for x, y in zip(a, p, strict=True):
        assert _rel(x.grad, y.grad) <= TOL


def test_resnet_rounds_repeat_bit_for_bit(cuda):
    """Two ResNet18 rounds (narrow, 16x16) from one seed, twice: the
    same round losses and params to the bit (the server makes cuDNN
    deterministic on the card)."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.progressive import make_adapter
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.federated.server import FLConfig, NeuLiteServer
    from repro_torch.models.cnn import CNNConfig

    def run():
        ccfg = CNNConfig(name="resnet18", arch="resnet18", num_classes=10,
                         image_size=16, width_mult=0.25)
        flc = FLConfig(n_devices=8, clients_per_round=2, local_epochs=1,
                       batch_size=16, num_stages=4, use_hsic_kernel=True,
                       seed=0)
        ds = make_image_dataset(0, 512, num_classes=10, image_size=16)
        parts = dirichlet_partition(0, ds.labels, flc.n_devices,
                                    alpha=flc.alpha)
        server = NeuLiteServer(make_adapter(ccfg, flc.num_stages),
                               [ds.subset(q) for q in parts], flc)
        losses = [repr(server.run_round(i).mean_loss) for i in range(2)]
        return losses, tree_leaves(server.params)

    (la, pa), (lb, pb) = run(), run()
    assert la == lb
    assert all(torch.equal(x, y) for x, y in zip(pa, pb, strict=True))


@pytest.mark.parametrize("case", SLSTM_CASES,
                         ids=[str(c) for c in SLSTM_CASES])
def test_slstm_autograd_matches_plain_path(cuda, case):
    inputs = _slstm_inputs(case, cuda)
    cot = _slstm_cotangents(inputs, cuda)
    sl_kernel.reset_launches()
    a = [t.clone().requires_grad_() for t in inputs]
    b = [t.clone().requires_grad_() for t in inputs]
    hs, fin = sl_ops.slstm_scan(*a[:3], dict(zip(STATE, a[3:])))
    torch.autograd.backward([hs] + [fin[k] for k in STATE], cot)
    hs_p, fin_p = sl_ref.slstm_scan_ref(*b[:3], dict(zip(STATE, b[3:])))
    torch.autograd.backward([hs_p] + [fin_p[k] for k in STATE], cot)
    assert sl_kernel.LAUNCHES == {"slstm_scan_fwd": 1, "slstm_scan_bwd": 1}
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
