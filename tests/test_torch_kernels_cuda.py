"""The CUDA kernels (streaming and dense-Gram nHSIC, flash-attention
forward, sLSTM scan forward and backward) against their plain versions,
the ResNet path's rounds against themselves, and the paper's memory claim
(every stage's measured peak below the full-model step's), on the card.  Marked
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
         (48, 8192, 64, False, False), (16, 3, 5, False, False),
         # h_xz of VGG11's and SqueezeNet's stages not above (the paper's
         # widths, batch 32): D = 384 is off a power of two
         (32, 3, 128, False, False), (32, 512, 512, False, False),
         (32, 256, 384, False, False), (32, 384, 512, False, False)]


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


# K1 at the edges of its cluster (K2's and K3's: D = 1 and below the
# cluster size, off a multiple of 4, 4096 and above) and at B = 1, 16 (one
# entry of a thread's four live), 33 and 256 (more than one tile): (B, Dx,
# Dz), each with both sides RBF, both linear, and one of each
ROWSUM_CASES = [(1, 5, 1), (16, 4096, 100), (33, 10, 4096), (48, 100, 33),
                (256, 1, 4096), (33, 4100, 3), (48, 8192, 64), (1, 7, 9),
                (16, 64, 128), (33, 256, 64), (256, 256, 64)]
SIDES = [(False, False), (True, True), (True, False)]


def _rowsum_inputs(B, Dx, Dz, lx, lz, device):
    rng = np.random.default_rng(B * 1000 + Dx + Dz)
    sides = []
    for D, linear in ((Dx, lx), (Dz, lz)):
        if linear:
            a = np.eye(D, dtype=np.float32)[rng.integers(0, D, B)]
        else:
            a = rng.standard_normal((B, D)).astype(np.float32)
        sides.append(torch.from_numpy(a).to(device))
    x, z = sides
    one = torch.ones((), device=device)
    s2 = torch.stack([one if lx else hsic.rbf_sigma2(x),
                      one if lz else hsic.rbf_sigma2(z)])
    return x, z, s2


@pytest.mark.parametrize("sides", SIDES, ids=["rbf-rbf", "lin-lin",
                                              "lin-rbf"])
@pytest.mark.parametrize("case", ROWSUM_CASES,
                         ids=[str(c) for c in ROWSUM_CASES])
def test_rowsums_kernel_matches_plain_version(cuda, case, sides):
    """K1 against its plain version, each side at the bar; a single RBF
    row sums to exactly 1 (its own value: the plain version's clamped
    bandwidth turns its rounding of a zero distance into exp(-big))."""
    B, Dx, Dz = case
    lx, lz = sides
    x, z, s2 = _rowsum_inputs(B, Dx, Dz, lx, lz, cuda)
    kernel.reset_launches()
    got = kernel.nhsic_rowsums(x, z, s2, linear_x=lx, linear_z=lz)
    want = ref.nhsic_rowsums(x, z, s2, linear_x=lx, linear_z=lz)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["nhsic_rowsums"] == 1
    for g, w, linear in zip(got, want, sides):
        assert g.shape == (B,) and g.dtype == torch.float32
        assert torch.isfinite(g).all()
        if B == 1 and not linear:
            assert torch.equal(g, torch.ones_like(g))
        else:
            assert _rel(g, w) <= TOL


@pytest.mark.parametrize("case", IDENTICAL_CASES,
                         ids=[str(c) for c in IDENTICAL_CASES])
def test_rowsums_of_identical_rows_are_exactly_B(cuda, case):
    x, z = _inputs(case, cuda)
    B = x.shape[0]
    s2 = torch.stack([hsic.rbf_sigma2(x), hsic.rbf_sigma2(z)])
    rxs, rzs = kernel.nhsic_rowsums(x, z, s2)
    assert bool((rxs == B).all()) and bool((rzs == B).all())


@pytest.mark.parametrize("case", REPEAT_CASES,
                         ids=[str(c) for c in REPEAT_CASES])
def test_rowsums_kernel_repeats_its_bits(cuda, case):
    x, z = _inputs(case, cuda)
    s2 = torch.stack([hsic.rbf_sigma2(x), hsic.rbf_sigma2(z)])
    runs = [kernel.nhsic_rowsums(x, z, s2) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for r in runs for a, b in zip(r, runs[0]))


def _device_ops(fn, runs=5, tries=3):
    """(device ops per call of ``fn``, the names of those ops) from the
    profiler.  The profiler now and then drops device events; every call
    here launches at least one op, so a profile with fewer events than
    calls lost some and is taken again, at most ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) >= runs:
            break
    return len(names) / runs, set(names)


@pytest.mark.parametrize("B", [32, 256])
def test_rowsums_kernel_is_one_device_op(cuda, B):
    x, z = _inputs((B, 256, 512, False, False), cuda)
    s2 = torch.stack([hsic.rbf_sigma2(x), hsic.rbf_sigma2(z)])
    n, names = _device_ops(lambda: kernel.nhsic_rowsums(x, z, s2))
    assert n == 1 and all("nhsic_rowsums_kernel" in k for k in names)


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
@pytest.mark.parametrize("B", [256, 32, 16, 1, 33, 200, 512, 513, 1000])
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


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nonsym"])
@pytest.mark.parametrize("B", [256, 32, 16, 33, 512, 1000])
def test_gram_stats_kernel_holds_near_constant_grams(cuda, B, symmetric):
    """Every entry in 1 +- 1e-3: centring cancels all but the last three
    digits.  The two Grams share half their variation, so the trace term
    is about half the norms; between two independent ones it is a sum that
    cancels to f32 rounding noise (the plain version's too), which no
    relative bar can hold."""
    rng = np.random.default_rng(B + 7)
    u, v = (rng.uniform(-1, 1, (B, B)) for _ in range(2))
    if symmetric:
        u, v = (u + u.T) / 2, (v + v.T) / 2
    kx, kz = (torch.from_numpy((1 + 1e-3 * a).astype(np.float32)).to(cuda)
              for a in (u, (u + v) / 2))
    got = kernel.gram_stats(kx, kz)
    want = ref.gram_stats(kx, kz)
    torch.cuda.synchronize()
    assert float(((got - want).abs() / want.abs().clamp_min(1e-6)).max()) \
        <= TOL


@pytest.mark.parametrize("B", [32, 256, 1000])
def test_gram_stats_kernel_is_one_device_op(cuda, B):
    """The wrapper issues the kernel alone: it reduces the means itself."""
    kx, kz = (_gram_input(B, 8, cuda, False) for _ in range(2))
    kx, kz = kernel.gram(kx, 8.0), kernel.gram(kz, 8.0)
    n, names = _device_ops(lambda: kernel.gram_stats(kx, kz))
    assert n == 1 and all("gram_stats_kernel" in k for k in names)


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


# the LLM training shapes (chip_smoke.py main paths 12, 13): qwen3-1.7b's 16
# over 8 heads of 128 at B 8, S 64 (bf16 and f32) and B 4, S 256;
# musicgen-large's 32 heads of 64 at B 4, S 256; the padded
# llava-next-34b's 64 over 8 heads of 128 over 2880 patches and 128 text
# tokens at B 2
FLASH_TRAIN = [
    (8, 64, 64, 16, 8, 128, True, 0, "bfloat16"),
    (8, 64, 64, 16, 8, 128, True, 0, "float32"),
    (4, 256, 256, 16, 8, 128, True, 0, "float32"),
    (4, 256, 256, 32, 32, 64, True, 0, "float32"),
    (2, 3008, 3008, 64, 8, 128, True, 0, "float32"),
    # jamba-1.5-large-398b's attention at full width and in its smoke
    # config's training
    (2, 512, 512, 64, 8, 128, True, 0, "float32"),
    (8, 64, 64, 4, 4, 64, True, 0, "float32"),
]


@pytest.mark.parametrize("case", FLASH_TRAIN, ids=[str(c) for c in
                                                   FLASH_TRAIN])
def test_flash_training_shapes_forward_and_gradient(cuda, case):
    """K4's forward against the plain version, and autograd of the op
    (the kernel forward, the plain VJP) against autograd of the plain
    version, at the LLM training shapes."""
    causal, window, dtype = case[6], case[7], case[8]
    q, k, v = _flash_inputs(case, cuda)
    fa_kernel.reset_launches()
    got = fa_kernel.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window)
    want = fa_ref.attention_ref(q, k, v, causal=causal, window=window)
    assert fa_kernel.LAUNCHES == {"flash_attention_fwd": 1}
    tol = TOL if dtype == "float32" else 2e-2
    assert got.dtype == q.dtype and _rel(got.float(), want.float()) <= tol
    del got, want
    g = torch.randn(q.shape, device=cuda, generator=torch.Generator(
        cuda).manual_seed(0)).to(q.dtype)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    fa_ops.flash_attention(*a, causal=causal, window=window).backward(g)
    fa_ref.attention_ref(*b, causal=causal, window=window).backward(g)
    for x, y in zip(a, b):
        assert _rel(x.grad.float(), y.grad.float()) <= tol
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


def _slstm_inputs(case, device, seed=None):
    B, S, H, Dh, random_state0, scale = case
    rng = np.random.default_rng(B * 1000 + S * 10 + Dh if seed is None
                                else seed)
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


def _launched(case, counts):
    """Whether K5's ``LAUNCHES`` after one call of ``case`` are right: one
    launch a kernel, except where the heads exceed what the card holds at
    once (H = 1100 at one block a head: more than 8 blocks an SM on 132
    SMs), and then several."""
    return all(n > 1 if case[2] > 1056 else n == 1 for n in counts)


@pytest.mark.parametrize("case", SLSTM_CASES,
                         ids=[str(c) for c in SLSTM_CASES])
def test_slstm_kernel_matches_plain_version(cuda, case):
    g_in, r, b, *st = _slstm_inputs(case, cuda)
    sl_kernel.reset_launches()
    got = sl_kernel.slstm_scan_fwd(g_in, r, b, *st)
    hs, fin = sl_ref.slstm_scan_ref(g_in, r, b, dict(zip(STATE, st)))
    torch.cuda.synchronize()
    assert sl_kernel.LAUNCHES["slstm_scan_bwd"] == 0
    assert _launched(case, [sl_kernel.LAUNCHES["slstm_scan_fwd"]])
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
    assert _launched(case, sl_kernel.LAUNCHES.values())
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


@pytest.mark.parametrize("arch", ["resnet18", "vgg11"])
def test_every_stage_peaks_below_the_full_step(cuda, arch):
    """The paper's memory claim on a narrow model (width 0.25, 16x16, 4
    stages, batch 64): each stage's measured peak over two local steps is
    below the full-model step's on the same batches."""
    from repro_torch.analysis.memory import (audit_memory,
                                             measure_local_training)
    from repro_torch.benchmarks.fig6_memory import two_batches
    from repro_torch.core.curriculum import CurriculumHP
    from repro_torch.core.progressive import make_adapter
    from repro_torch.data.loader import Batcher
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.models.cnn import CNNConfig
    from repro_torch.optim.optimizers import sgd

    adapter = make_adapter(CNNConfig(name=arch, arch=arch, image_size=16,
                                     width_mult=0.25), 4)
    params = adapter.init_params(0, "cpu")
    batches = two_batches(Batcher(make_image_dataset(0, 128, image_size=16),
                                  64))
    opt, hp = sgd(0.05), CurriculumHP(use_hsic_kernel=True)
    stages = [measure_local_training(adapter, params, batches, opt, stage=t,
                                     hp=hp, device=cuda) for t in range(4)]
    full = measure_local_training(adapter, params, batches, opt, hp=hp,
                                  device=cuda)
    assert all(m.num_batches == 2 for m in stages + [full])
    assert all(np.isfinite(m.mean_loss) for m in stages + [full])
    assert all(0 < m.resident_bytes < m.peak_bytes for m in stages + [full])
    _, failures = audit_memory({t: m.peak_bytes for t, m in
                                enumerate(stages)}, full.peak_bytes)
    assert not failures, failures


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
    assert _launched(case, sl_kernel.LAUNCHES.values())
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


# K5 over cohorts, (B, S, H, Dh): the xLSTM smoke config's width (16 blocks
# a cohort) and xlstm-1.3b's (128 blocks a cohort, one an SM), then a
# ragged shape (3 row chunks, head dim off the tile)
BATCHED_SLSTM = [(8, 64, 4, 64), (8, 256, 4, 512), (40, 9, 3, 20)]


def _cohort_launches(case, C, shared):
    """K5's launches for C cohorts on this card: shared r folds into one
    launch; a cohort's heads take H ceil(Dh/16) blocks, as many whole heads
    as the card holds at once go to a launch (xlstm-1.3b's 128 blocks of
    165 KiB: one cohort a launch on a card of 128-255 SMs)."""
    B, S, H, Dh = case
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if shared or Dh <= 64:
        return 1
    assert 128 <= sms < 256, sms
    return C


def _stack_inputs(case, C, shared, device):
    """C cohorts' sLSTM inputs, each drawn as ``_slstm_inputs`` draws them
    (random initial states) from a seed of its own; r and b cohort 0's
    where ``shared``."""
    per = [_slstm_inputs((*case, True, 1.0), device, seed=100 * C + c)
           for c in range(C)]
    stack = [torch.stack(ts) for ts in zip(*per)]
    if shared:
        stack[1], stack[2] = stack[1][0], stack[2][0]
    return stack


@pytest.mark.parametrize("shared", [False, True], ids=["own-r", "shared-r"])
@pytest.mark.parametrize("C", [1, 3, 4])
@pytest.mark.parametrize("case", BATCHED_SLSTM,
                         ids=[str(c) for c in BATCHED_SLSTM])
def test_batched_slstm_equals_per_cohort_launches(cuda, case, C, shared):
    """K5's forward and backward under ``torch.func.vmap`` over C cohorts:
    each cohort the bits of a launch of its own and within the bar of the
    plain versions, in the predicted number of launches (per-cohort r: the
    cohorts' heads in groups of whole heads; shared r: one launch, the
    cohorts folded into the rows)."""
    g_in, r, b, *st = _stack_inputs(case, C, shared, cuda)
    rd = None if shared else 0
    sl_kernel.reset_launches()
    out = torch.func.vmap(
        lambda g, r_, b_, *s: sl_kernel.slstm_scan_fwd(g, r_, b_, *s,
                                                       save=True),
        in_dims=(0, rd, rd, 0, 0, 0, 0))(g_in, r, b, *st)
    want = _cohort_launches(case, C, shared)
    assert sl_kernel.LAUNCHES["slstm_scan_fwd"] == want
    gen = torch.Generator(cuda).manual_seed(2)
    cot = [torch.randn(t.shape, device=cuda, generator=gen)
           for t in out[:5]]
    back = torch.func.vmap(sl_kernel.slstm_scan_bwd,
                           in_dims=(0, 0, 0, 0, rd) + (0,) * 8)(
        *out[5:], r, *st[:3], *cot)
    assert sl_kernel.LAUNCHES["slstm_scan_bwd"] == want
    for c in range(C):
        rc, bc = (r, b) if shared else (r[c], b[c])
        own = sl_kernel.slstm_scan_fwd(g_in[c], rc, bc, *(s[c] for s in st),
                                       save=True)
        assert all(torch.equal(a[c], o) for a, o in zip(out, own,
                                                          strict=True))
        own_b = sl_kernel.slstm_scan_bwd(*own[5:], rc, *(s[c] for s in
                                                          st[:3]),
                                         *(t[c] for t in cot))
        assert all(torch.equal(a[c], o) for a, o in zip(back, own_b,
                                                          strict=True))
        hs, fin = sl_ref.slstm_scan_ref(g_in[c], rc, bc,
                                        dict(zip(STATE, (s[c] for s in st))))
        for a, w in zip(own[:5], [hs] + [fin[k] for k in STATE]):
            assert _rel(a, w) <= TOL
        wb = sl_ref.slstm_scan_bwd_ref(*own[5:], rc, *(s[c] for s in
                                                       st[:3]),
                                       *(t[c] for t in cot))
        for a, w in zip(own_b, wb):
            assert _rel(a, w) <= TOL


@pytest.mark.parametrize("shared", [False, True], ids=["own-r", "shared-r"])
def test_vmap_grad_of_slstm_scan_equals_a_loop(cuda, shared):
    """vmap(grad) through the differentiable scan (``ops.slstm_scan``) at
    the smoke width over 4 cohorts: one forward and one backward launch,
    the gradients those of a loop over the cohorts to the bit."""
    case = BATCHED_SLSTM[0]
    g_in, r, b, *st = _stack_inputs(case, 4, shared, cuda)
    rd = None if shared else 0

    def loss(g, r_, b_, *s):
        hs, fin = sl_ops.slstm_scan(g, r_, b_, dict(zip(STATE, s)))
        return hs.square().sum() + fin["c"].sum()

    grad = torch.func.grad(loss, argnums=(0, 1, 2))
    sl_kernel.reset_launches()
    got = torch.func.vmap(grad, in_dims=(0, rd, rd, 0, 0, 0, 0))(
        g_in, r, b, *st)
    assert sl_kernel.LAUNCHES == {"slstm_scan_fwd": 1, "slstm_scan_bwd": 1}
    for c in range(4):
        rc, bc = (r, b) if shared else (r[c], b[c])
        want = grad(g_in[c], rc, bc, *(s[c] for s in st))
        # g_in's gradient is the backward kernel's output; r's and b's are
        # products of it, batched by torch
        assert torch.equal(got[0][c], want[0])
        for a, w in zip(got[1:], want[1:]):
            assert _rel(a[c], w) <= TOL


def test_default_round_fits_what_an_eager_round_fits(cuda):
    """With the process capped just above an eager xLSTM round's reserved
    peak (110% of it), the default (captured) runtime's rounds of the same
    stage still fit, each reserving at most 110% of the eager round's, the
    second after one of its own stage (as under a sequential schedule):
    a round hands its graph's pool back after its last local step, before
    Eq. 1, and the frozen prefix and ``global_ref`` are read in place.  A
    first captured round comes before: a process's first capture leaves
    cuBLAS a workspace for the capture stream for its life."""
    import dataclasses
    import gc

    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import xlstm_1_3b
    from repro_torch.core.curriculum import CurriculumHP
    from repro_torch.core.progressive import make_adapter
    from repro_torch.data.loader import Batcher
    from repro_torch.data.synthetic import make_lm_dataset
    from repro_torch.federated.runtime import SequentialRuntime
    from repro_torch.optim.optimizers import sgd
    cfg = dataclasses.replace(xlstm_1_3b.smoke_config(),
                              use_slstm_kernel=True)
    adapter = make_adapter(cfg, 2)
    params = adapter.init_params(0, cuda)
    batchers = [Batcher(make_lm_dataset(s, 64, 128, cfg.vocab_size), 16,
                        seed=s, kind="lm") for s in range(2)]
    hp = CurriculumHP(use_hsic_kernel=True)

    def peak(runtime):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = runtime.run_round(params, 1, batchers, [0, 1], 1)
        torch.cuda.synchronize()
        assert all(torch.isfinite(p).all() for p in
                   tree_leaves(out.trainable))
        del out
        return torch.cuda.max_memory_reserved()

    def runtime(capture):
        return SequentialRuntime(adapter, sgd(1e-4), hp, cuda,
                                 capture=capture)

    peak(runtime(True))
    eager = peak(runtime(False))
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(1.1 * eager / total)
    try:
        default = runtime(True)
        captured = [peak(default) for _ in range(2)]
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    assert max(captured) <= 1.1 * eager


# (B, Dx, Dz, linear_x) of the batched K1-K3 checks: the training batches
# (16, 32, 128) at the main paths' h_xz and h_yz widths
BATCHED_CASES = [(32, 3, 64, False), (32, 256, 512, False),
                 (16, 2048, 2048, False), (16, 256, 64, True),
                 (128, 64, 128, False), (32, 384, 384, False),
                 (32, 10, 64, True), (32, 100, 64, True)]


def _batched_inputs(C, case, device):
    B, Dx, Dz, lx = case
    rng = np.random.default_rng(C * 7 + B)
    x = torch.from_numpy(rng.standard_normal((C, B, Dx)).astype(
        np.float32)).to(device)
    z = torch.from_numpy(rng.standard_normal((C, B, Dz)).astype(
        np.float32)).to(device)
    return x, z


@pytest.mark.parametrize("C", [1, 3, 4])
@pytest.mark.parametrize("case", BATCHED_CASES,
                         ids=[str(c) for c in BATCHED_CASES])
def test_batched_kernels_equal_per_cohort_launches(cuda, case, C):
    """K1-K3 on a (C, B, D) stack: one launch each, every cohort's result
    the same bits as a launch of its own, and within the bar of the plain
    version."""
    lx = case[3]
    x, z = _batched_inputs(C, case, cuda)
    per = [_kernel_args(x[c], z[c], lx) for c in range(C)]
    rx, rz, s = (torch.stack([p[i] for p in per]) for i in (0, 1, 2))
    s2 = s[:, :2].contiguous()
    kernel.reset_launches()
    rxs, rzs = kernel.nhsic_rowsums(x, z, s2, linear_x=lx)
    stats = kernel.nhsic_stats_feats(x, z, rx, rz, s, linear_x=lx)
    scal = torch.cat([s, torch.rand(C, 3, device=cuda) + 0.5], dim=1)
    dx, dz = kernel.nhsic_grad(x, z, rx, rz, scal, linear_x=lx)
    assert kernel.LAUNCHES["nhsic_rowsums"] == 1
    assert kernel.LAUNCHES["nhsic_stats_feats"] == 1
    assert kernel.LAUNCHES["nhsic_grad"] == 1
    for c in range(C):
        one = kernel.nhsic_rowsums(x[c], z[c], s2[c], linear_x=lx)
        assert torch.equal(rxs[c], one[0]) and torch.equal(rzs[c], one[1])
        assert torch.equal(stats[c], kernel.nhsic_stats_feats(
            x[c], z[c], rx[c], rz[c], s[c], linear_x=lx))
        g = kernel.nhsic_grad(x[c], z[c], rx[c], rz[c], scal[c],
                              linear_x=lx)
        assert torch.equal(dx[c], g[0]) and torch.equal(dz[c], g[1])
        want = ref.nhsic_grad(x[c], z[c], rx[c], rz[c], scal[c],
                              linear_x=lx)
        assert _rel(dx[c], want[0]) <= TOL and _rel(dz[c], want[1]) <= TOL
        want = ref.nhsic_stats_feats(x[c], z[c], rx[c], rz[c], s[c],
                                     linear_x=lx)
        assert _rel(stats[c], want) <= TOL


def test_vmapped_nhsic_launches_once_per_kernel(cuda):
    """vmap(grad(nhsic)) over 4 cohorts: K1, K2 and K3 once each, the
    gradients those of a loop over the cohorts."""
    x = torch.randn(4, 32, 256, device=cuda)
    z = torch.randn(4, 32, 512, device=cuda)
    grad = torch.func.grad(lambda a, b: ops.nhsic(a, b), argnums=(0, 1))
    kernel.reset_launches()
    gx, gz = torch.func.vmap(grad)(x, z)
    assert {n: kernel.LAUNCHES[n] for n in ("nhsic_rowsums",
                                            "nhsic_stats_feats",
                                            "nhsic_grad")} == {
        "nhsic_rowsums": 1, "nhsic_stats_feats": 1, "nhsic_grad": 1}
    for c in range(4):
        a, b = grad(x[c], z[c])
        assert torch.equal(gx[c], a) and torch.equal(gz[c], b)


def test_folded_flash_equals_separate_launches(cuda):
    """K4 under vmap over 4 cohorts folds them into its batch axis: one
    launch, the same bits as four."""
    q, k, v = (torch.randn(4, 32, 64, 6, 64, device=cuda) for _ in range(3))
    fa_kernel.reset_launches()
    out = torch.func.vmap(lambda a, b, c: fa_kernel.flash_attention_fwd(
        a, b, c, causal=False))(q, k, v)
    assert fa_kernel.LAUNCHES["flash_attention_fwd"] == 1
    for c in range(4):
        assert torch.equal(out[c], fa_kernel.flash_attention_fwd(
            q[c], k[c], v[c], causal=False))


def _small_cnn(device, stages=2):
    from repro_torch.core.progressive import make_adapter
    from repro_torch.models.cnn import CNNConfig
    adapter = make_adapter(CNNConfig(name="resnet18", arch="resnet18",
                                     image_size=16, width_mult=0.25), stages)
    return adapter, adapter.init_params(0, device)


def _image_batches(n, device, B=16, seed=0):
    rng = np.random.default_rng(seed)
    return [{"inputs": {"images": torch.from_numpy(rng.standard_normal(
        (B, 16, 16, 3)).astype(np.float32)).to(device)},
        "labels": torch.from_numpy(rng.integers(0, 10, B).astype(
            np.int32)).to(device)} for _ in range(n)]


def test_replayed_step_equals_the_eager_step(cuda):
    """Three replays of the captured stage step against three eager steps
    from the same state: params, optimizer state and losses to the bit;
    K1-K3 counted twice a replayed step."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.curriculum import CurriculumHP
    from repro_torch.core.progressive import (CapturedStep, jit_stage_step,
                                              make_stage_step)
    from repro_torch.optim.optimizers import sgd
    torch.backends.cudnn.deterministic = True
    adapter, params = _small_cnn(cuda)
    batches = _image_batches(3, cuda)
    opt, hp = sgd(0.05), CurriculumHP(use_hsic_kernel=True)
    for t in range(2):
        frozen, trainable = adapter.split_stage(params, t)
        runs = []
        for step in (make_stage_step(adapter, opt, hp, t),
                     jit_stage_step(adapter, opt, hp, t, device=cuda)):
            kernel.reset_launches()
            state, tr, losses = opt.init(trainable), trainable, []
            for b in batches:
                state, tr, m = step(state, tr, frozen, b, trainable)
                losses.append(m["loss"])
            runs.append((tree_leaves([state, tr]), losses,
                         dict(kernel.LAUNCHES)))
        assert isinstance(step, CapturedStep)
        (ea, el, ec), (ca, cl, cc) = runs
        assert all(torch.equal(a, b) for a, b in zip(ea, ca, strict=True))
        assert all(torch.equal(a, b) for a, b in zip(el, cl, strict=True))
        assert ec == cc and cc["nhsic_grad"] == 2 * len(batches)


def test_four_clients_give_four_uploads(cuda):
    """The captured step reuses its buffers: four clients with different
    data, one after another through one step, upload four different
    trees, each the same bits as the client's eager training."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.curriculum import CurriculumHP
    from repro_torch.core.progressive import jit_stage_step, make_stage_step
    from repro_torch.data.loader import Batcher
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.federated.client import run_local_training
    from repro_torch.optim.optimizers import sgd
    torch.backends.cudnn.deterministic = True
    adapter, params = _small_cnn(cuda)
    frozen, trainable = adapter.split_stage(params, 0)
    opt, hp = sgd(0.05), CurriculumHP(use_hsic_kernel=True)
    data = [make_image_dataset(s, 48, image_size=16) for s in range(4)]
    uploads = {}
    for name, step in (("captured", jit_stage_step(adapter, opt, hp, 0,
                                                   device=cuda)),
                       ("eager", make_stage_step(adapter, opt, hp, 0))):
        # fresh batchers: a batcher's order advances with every epoch drawn
        uploads[name] = [tree_leaves(run_local_training(
            step, opt, trainable, frozen, Batcher(ds, 16, seed=s), 1,
            global_ref=trainable, device=cuda).trainable)
            for s, ds in enumerate(data)]
    cap = uploads["captured"]
    for i in range(4):
        assert all(torch.equal(a, b) for a, b in zip(cap[i],
                                                     uploads["eager"][i]))
        for j in range(i):
            assert not all(torch.equal(a, b) for a, b in zip(cap[i], cap[j]))


def test_graphs_of_an_old_stage_are_released(cuda):
    """A round drops its graphs after its last local step: once its
    outcome is dropped, the memory the captured stage held is allocated no
    more, and its graph's pool is no longer reserved, while the round
    reserved more than that at its peak.  A first round comes before the
    measurement: a process's first capture also leaves cuBLAS a workspace
    for the capture stream, which PyTorch keeps for the process's life."""
    import gc

    from repro_torch.core.curriculum import CurriculumHP
    from repro_torch.data.loader import Batcher
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.federated.runtime import SequentialRuntime
    from repro_torch.optim.optimizers import sgd
    adapter, params = _small_cnn(cuda)
    runtime = SequentialRuntime(adapter, sgd(0.05),
                                CurriculumHP(use_hsic_kernel=True), cuda)
    batchers = [Batcher(make_image_dataset(s, 32, image_size=16), 16,
                        seed=s) for s in range(2)]
    runtime.run_round(params, 0, batchers, [0, 1], 1)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    out = runtime.run_round(params, 0, batchers, [0, 1], 1)
    assert not runtime._programs      # dropped with their graphs
    del out
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_reserved() > reserved   # the graph's pool
    torch.cuda.empty_cache()      # Eq. 1's eager blocks
    assert torch.cuda.memory_allocated() <= before
    assert torch.cuda.memory_reserved() <= reserved


def test_replay_reads_a_frozen_leaf_changed_in_place(cuda):
    """The graph reads the frozen prefix in place (and copies the other
    arguments in at every call): a frozen leaf changed in place between
    two calls, through ``.data`` (which leaves the tensor's version counter
    as it was), reaches the replay, whose step is then the same bits as
    the eager step on the changed leaf."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.curriculum import CurriculumHP
    from repro_torch.core.progressive import jit_stage_step, make_stage_step
    from repro_torch.optim.optimizers import sgd
    torch.backends.cudnn.deterministic = True
    adapter, params = _small_cnn(cuda)
    (batch,) = _image_batches(1, cuda)
    opt, hp = sgd(0.05), CurriculumHP(use_hsic_kernel=True)
    frozen, trainable = adapter.split_stage(params, 1)
    captured = jit_stage_step(adapter, opt, hp, 1, device=cuda)
    first = tree_leaves(captured(opt.init(trainable), trainable, frozen,
                                 batch, trainable)[1])
    first = [p.clone() for p in first]
    for leaf in tree_leaves(frozen):
        leaf.data.mul_(1.5)
    _, got, gm = captured(opt.init(trainable), trainable, frozen, batch,
                          trainable)
    _, want, wm = make_stage_step(adapter, opt, hp, 1)(
        opt.init(trainable), trainable, frozen, batch, trainable)
    assert torch.equal(gm["loss"], wm["loss"])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(want), strict=True))
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(got), first))


def test_launches_after_replays_and_vectorized_rounds(cuda):
    """A captured sequential round and a vectorized round of 3 cohorts:
    K1-K3 counted exactly twice per local step (per vectorized step,
    whatever the number of cohorts); the two rounds agree at the round
    bar (1e-3 of the largest update)."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.curriculum import CurriculumHP
    from repro_torch.data.loader import Batcher, stack_round
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.federated.runtime import (SequentialRuntime,
                                               VectorizedRuntime)
    from repro_torch.optim.optimizers import sgd
    torch.backends.cudnn.deterministic = True
    adapter, params = _small_cnn(cuda)
    hp = CurriculumHP(use_hsic_kernel=True)
    stack = stack_round([Batcher(make_image_dataset(s, 16 * (s + 2),
                                                    image_size=16), 16,
                                 seed=s) for s in range(3)], [0, 1, 2],
                        local_epochs=1)
    _, start = adapter.split_stage(params, 1)
    out = {}
    for name, cls in (("sequential", SequentialRuntime),
                      ("vectorized", VectorizedRuntime)):
        kernel.reset_launches()
        new, _ = cls(adapter, sgd(0.05), hp, cuda).run_stacked(params, 1,
                                                                stack)
        out[name] = (tree_leaves(new), dict(kernel.LAUNCHES))
    steps = int(stack.step_mask.sum())
    assert out["sequential"][1]["nhsic_grad"] == 2 * steps
    assert out["vectorized"][1]["nhsic_grad"] == 2 * stack.max_steps
    for n in ("nhsic_rowsums", "nhsic_stats_feats"):
        assert out["sequential"][1][n] == 2 * steps
        assert out["vectorized"][1][n] == 2 * stack.max_steps
    upd = [a - s for a, s in zip(out["sequential"][0], tree_leaves(start))]
    scale = max(float(u.abs().max()) for u in upd if u.numel())
    diff = max(float((a - b).abs().max()) for a, b in
               zip(out["sequential"][0], out["vectorized"][0]) if a.numel())
    assert diff <= 1e-3 * scale
