"""The port's kernel benchmark (``repro_torch.benchmarks.kernels_bench``)
and the im2col conv it times, against the JAX reference.

On the CPU the benchmark times the plain versions (the kernel wrappers take
them for CPU tensors); what is checked here is that it runs, writes the
reference's rows and keys with the device named, and that the nHSIC
backward keeps O(B·D) residuals, byte for byte what the reference keeps.
The im2col conv is held to the reference's ``_conv_im2col`` and to the
port's native conv at scale-relative 1e-4, after the NHWC/HWIO ->
NCHW/OIHW transposes.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hsic_gram import ops as r_ops
from repro.models import cnn as r_cnn
from repro_torch.benchmarks import common, kernels_bench
from repro_torch.kernels.hsic_gram import kernel as t_kernel
from repro_torch.models import cnn as t_cnn

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "bench_kernels.json"
    t_kernel.reset_launches()
    rows = kernels_bench.run(device="cpu", quiet=True, out_path=path)
    launches = dict(t_kernel.LAUNCHES)
    return rows, json.loads(path.read_text()), launches


def test_bench_writes_the_reference_rows_and_names_the_device(bench):
    rows, doc, launches = bench
    ref_rows = json.loads((ROOT / "BENCH_kernels.json").read_text())["rows"]
    assert set(doc["rows"]) == set(ref_rows) == set(rows)
    for name, ref_row in ref_rows.items():
        assert set(ref_row) <= set(doc["rows"][name]), name
        assert all(np.isfinite(v) and v >= 0
                   for v in doc["rows"][name].values()), name
    for name in ("nhsic_B64_D128", "nhsic_B256_D256"):
        assert doc["rows"][name]["fwd_unfused_s"] > 0
    assert doc["meta"]["device"] == "cpu"
    assert doc["meta"]["torch"] == torch.__version__
    assert "conv_lax" in doc["meta"]["notes"]
    # CPU tensors take the plain versions: no kernel launched
    assert all(c == 0 for c in launches.values())


def test_quick_prints_one_csv_line(bench, monkeypatch, capsys):
    rows = bench[0]
    monkeypatch.setattr(kernels_bench, "run", lambda device, quiet: rows)
    kernels_bench.main(["--quick", "--device", "cpu"])
    name, us, derived = capsys.readouterr().out.strip().split(",")
    assert name == "kernels_bench" and float(us) >= 0
    assert derived.split() == [
        f"attn_S1024_gflops={rows['attn_ref_S1024']['gflops']:.1f}",
        f"nhsic_grad_residual_ratio="
        f"{rows['nhsic_B64_D128']['residual_ratio']:.2f}"]


@pytest.mark.parametrize("B,D", [(64, 128), (256, 256)])
def test_bench_residuals_equal_the_reference(bench, B, D):
    row = bench[0][f"nhsic_B{B}_D{D}"]
    x = jnp.zeros((B, D))
    z = jnp.zeros((B, kernels_bench.NHSIC_DZ))
    _, res = r_ops.nhsic_residuals(x, z, interpret=True)
    leaves = jax.tree.leaves(res)
    assert row["bwd_residual_bytes"] == sum(
        leaf.size * leaf.dtype.itemsize for leaf in leaves)
    assert row["naive_gram_bytes"] == 4 * B * B * 4
    assert row["residual_ratio"] == (row["bwd_residual_bytes"]
                                     / row["naive_gram_bytes"])


def test_bench_refuses_a_square_residual(monkeypatch):
    real = kernels_bench.kops.nhsic_residuals

    def leaky(x, z):
        value, res = real(x, z)
        return value, (*res, torch.zeros(x.shape[0], x.shape[0]))

    monkeypatch.setattr(kernels_bench.kops, "nhsic_residuals", leaky)
    monkeypatch.setattr(kernels_bench, "NHSIC_SHAPES", [(64, 8)])
    with pytest.raises(RuntimeError, match="B×B residual"):
        kernels_bench._nhsic_rows(torch.Generator().manual_seed(0),
                                  torch.device("cpu"), {}, True)


def test_bench_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kernels_bench.run(quiet=True)


def test_timeit_returns_the_median():
    calls = []
    t = common.timeit(lambda a: calls.append(a), 7, warmup=2, iters=3)
    assert calls == [7] * 5 and 0.0 <= t < 1.0


CONV_CASES = [(k, s, H) for k in (1, 3) for s in (1, 2) for H in (7, 8)]


@pytest.mark.parametrize("k,stride,H", CONV_CASES,
                         ids=[f"k{k}-s{s}-H{h}" for k, s, h in CONV_CASES])
def test_im2col_conv_matches_reference_and_native(k, stride, H):
    rng = np.random.default_rng(k * 100 + stride * 10 + H)
    x = rng.standard_normal((2, H, H + 1, 5)).astype(np.float32)   # NHWC
    w = (rng.standard_normal((k, k, 5, 6)) * 0.3).astype(np.float32)  # HWIO
    want = np.asarray(r_cnn._conv_im2col({"w": jnp.asarray(w)},
                                         jnp.asarray(x), stride))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)                   # NCHW
    wt = {"w": torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()}  # OIHW
    got = t_cnn.conv(wt, xt, stride, impl="im2col")
    native = t_cnn.conv(wt, xt, stride)
    scale = float(np.max(np.abs(want)))
    for out in (got, native):
        out = out.permute(0, 2, 3, 1).numpy()
        assert out.shape == want.shape
        assert float(np.max(np.abs(out - want))) <= 1e-4 * scale


def test_conv_rejects_an_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        t_cnn.conv({"w": torch.zeros(2, 2, 3, 3)}, torch.zeros(1, 2, 4, 4),
                   1, impl="lax")


@pytest.mark.parametrize("impl", ["native", "im2col"])
def test_vmapped_conv_equals_a_loop_over_cohorts(impl):
    C, B, H, cin, cout, k = 4, 3, 8, 8, 8, 3
    g = torch.Generator().manual_seed(1)
    w = torch.randn((C, cout, cin, k, k), generator=g) * 0.1
    x = torch.randn((C, B, cin, H, H), generator=g)

    def unit(wi, xi):
        return t_cnn.conv({"w": wi}, xi, 1, impl)

    got = torch.func.vmap(unit)(w, x)
    want = torch.stack([unit(w[c], x[c]) for c in range(C)])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    g_vmap = torch.func.grad(lambda a: torch.func.vmap(unit)(a, x).sum())(w)
    wl = w.clone().requires_grad_(True)
    sum(unit(wl[c], x[c]).sum() for c in range(C)).backward()
    torch.testing.assert_close(g_vmap, wl.grad, rtol=1e-5, atol=1e-5)
