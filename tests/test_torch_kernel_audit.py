"""The kernel audit (``repro_torch.analysis.kernel_audit``) on the CPU: the
fuzzer's draws are the reference's to the bit (``pallas_audit``'s
``_fuzz_*_once`` run with its public ops and oracles replaced by stand-ins
that record their concrete inputs and return zeros), the port's plain
oracles agree with the reference's on two draws a family (forward and
gradients, 1e-3 in f32, 2e-2 in bf16), the fuzzer catches a divergence and
a crash, every family registers ``AUDIT_CASES`` naming only the
``__global__`` kernels of its source, and ``--kernels`` needs the card."""
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import pallas_audit
from repro_torch.analysis import kernel_audit as ka
from repro_torch.analysis.report import Report
from repro_torch.kernels.audit import global_kernels

N_DRAWS = 10
SEED = 0


class _Recording:
    """A numpy ``Generator`` that records every draw it hands out."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.draws = []

    def __getattr__(self, name):
        fn = getattr(self.rng, name)

        def draw(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.draws.append((name, np.array(out, copy=True)))
            return out
        return draw


def _concrete(x):
    try:
        return np.asarray(x)
    except Exception:           # a tracer: the calls under jax.grad
        return None


def _stand_ins(monkeypatch, seen):
    """The reference's public ops and oracles replaced by stand-ins that
    record their first concrete inputs and return zeros."""
    def record(name, *arrays):
        got = [_concrete(a) for a in arrays]
        if all(g is not None for g in got):
            seen.setdefault(name, got)

    def attention(q, k, v, **kw):
        record("flash", q, k, v)
        return jnp.zeros(q.shape, q.dtype)

    def scan(g_in, r, b, state0, **kw):
        record("slstm", g_in, r, b, *(state0[n] for n in "cnmh"))
        B, S, _, H, Dh = g_in.shape
        zero = jnp.zeros((B, H, Dh), jnp.float32)
        return (jnp.zeros((B, S, H, Dh), jnp.float32),
                {n: zero for n in "cnmh"})

    def nhsic(x, z, **kw):
        record("nhsic", x, z)
        return jnp.zeros((), jnp.float32)

    for mod, name, fn in (
            ("repro.kernels.flash_attention.ops", "flash_attention",
             attention),
            ("repro.kernels.flash_attention.ref", "attention_ref", attention),
            ("repro.kernels.slstm_scan.ops", "slstm_scan", scan),
            ("repro.kernels.slstm_scan.ref", "slstm_scan_ref", scan),
            ("repro.kernels.hsic_gram.ops", "nhsic", nhsic),
            ("repro.core.hsic", "nhsic", nhsic)):
        monkeypatch.setattr(importlib.import_module(mod), name, fn)


REF_FUZZERS = {"flash_attention": "_fuzz_flash_once",
               "hsic_gram": "_fuzz_nhsic_once",
               "slstm_scan": "_fuzz_slstm_once"}
OP_INPUTS = {"flash_attention": ("flash", "qkv"),
             "hsic_gram": ("nhsic", "xz"),
             "slstm_scan": ("slstm", ("g_in", "r", "b", "c", "n", "m", "h"))}


def _bits(a):
    a = np.asarray(a)
    if a.dtype.kind == "f" or str(a.dtype) == "bfloat16":
        return a.view(f"u{a.dtype.itemsize}")
    return a


@pytest.mark.parametrize("family", ka.FAMILIES)
def test_draws_are_the_references_to_the_bit(monkeypatch, family):
    i_fam = ka.FAMILIES.index(family)
    seed = 1_000_003 * (SEED + 1) + i_fam
    ref_rng, port_rng = _Recording(seed), _Recording(seed)
    draw, _ = ka.FUZZERS[family]
    op, names = OP_INPUTS[family]
    for i in range(N_DRAWS):
        seen = {}
        with monkeypatch.context() as m:
            _stand_ins(m, seen)
            ref_results = getattr(pallas_audit, REF_FUZZERS[family])(ref_rng)
        got = draw(port_rng)
        # the same parameters: shapes, flags, the block sizes drawn
        assert got["params"] == ref_results[0][3], (i, got["params"])
        # the same stream: every draw's method and bits
        assert len(port_rng.draws) == len(ref_rng.draws)
        for (pm, pv), (rm, rv) in zip(port_rng.draws, ref_rng.draws):
            assert pm == rm and pv.dtype == rv.dtype
            assert np.array_equal(_bits(pv), _bits(rv)), (i, pm)
        # the reference's op took the port's arrays, in its dtype
        dtype = getattr(torch, got["params"].get("dtype", "float32"))
        for name, ref_arr in zip(names, seen[op]):
            ours = torch.from_numpy(got["arrays"][name]).to(dtype)
            ours = (ours.view(torch.int16).numpy().view(np.uint16)
                    if dtype == torch.bfloat16 else _bits(ours.numpy()))
            assert np.array_equal(ours, _bits(ref_arr)), (i, name)


def _jax_flash(a, p):
    from repro.kernels.flash_attention.ref import attention_ref
    dt = jnp.bfloat16 if p["dtype"] == "bfloat16" else jnp.float32
    kw = dict(causal=p["causal"], window=p["window"])

    def both(q, k, v, w):
        out, vjp = jax.vjp(lambda *t: attention_ref(*t, **kw), q, k, v)
        return out, vjp(w.astype(out.dtype))

    out, grads = jax.jit(both)(*(jnp.asarray(a[n], dt) for n in "qkv"),
                               jnp.asarray(a["w"]))
    return [out, *grads]


def _jax_slstm(a, p):
    from repro.kernels.slstm_scan.ref import slstm_scan_ref

    def both(g_in, r, b, state0, w, wf):
        def loss(g_, r_, b_):
            hs, fin = slstm_scan_ref(g_, r_, b_, state0)
            return jnp.sum(hs * w) + jnp.sum(fin["h"] * wf), (hs, fin)
        grads, (hs, fin) = jax.grad(loss, argnums=(0, 1, 2),
                                    has_aux=True)(g_in, r, b)
        return hs, fin, grads

    hs, fin, grads = jax.jit(both)(
        *(jnp.asarray(a[n]) for n in ("g_in", "r", "b")),
        {n: jnp.asarray(a[n]) for n in "cnmh"}, jnp.asarray(a["w"]),
        jnp.asarray(a["wf"]))
    return [hs, *(fin[n] for n in "cnmh"), *grads]


def _jax_nhsic(a, p):
    from repro.core.hsic import nhsic
    kw = dict(kernel_x=p["kernel_x"], kernel_z=p["kernel_z"])
    value, grads = jax.jit(jax.value_and_grad(
        lambda x_, z_: nhsic(x_, z_, **kw), argnums=(0, 1)))(
            jnp.asarray(a["x"]), jnp.asarray(a["z"]))
    return [value, *grads]


def _torch_side(family, draw):
    """The port's plain oracle's outputs on a draw: what ``check_*`` holds
    the kernel against, with both sides the plain version (the CPU)."""
    a, p = draw["arrays"], draw["params"]
    cpu = torch.device("cpu")
    if family == "flash_attention":
        from repro_torch.kernels.flash_attention.ref import attention_ref
        dt = getattr(torch, p["dtype"])
        q, k, v = (torch.from_numpy(a[n]).to(dt) for n in "qkv")
        w = torch.from_numpy(a["w"])
        kw = dict(causal=p["causal"], window=p["window"])
        return [attention_ref(q, k, v, **kw), *ka._grads(
            lambda *t: (attention_ref(*t, **kw).float() * w).sum(),
            (q, k, v))]
    if family == "slstm_scan":
        from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref
        t = {n: torch.from_numpy(np.asarray(x, np.float32))
             for n, x in a.items()}
        state0 = {n: t[n] for n in "cnmh"}
        inputs = (t["g_in"], t["r"], t["b"])
        hs, fin = slstm_scan_ref(*inputs, state0)

        def loss(g_, r_, b_):
            hs_, fin_ = slstm_scan_ref(g_, r_, b_, state0)
            return (hs_ * t["w"]).sum() + (fin_["h"] * t["wf"]).sum()
        return [hs, *(fin[n] for n in "cnmh"), *ka._grads(loss, inputs)]
    from repro_torch.core.hsic import nhsic
    kw = dict(kernel_x=p["kernel_x"], kernel_z=p["kernel_z"])
    x, z = (torch.from_numpy(a[n]).to(cpu) for n in "xz")
    return [nhsic(x, z, **kw),
            *ka._grads(lambda x_, z_: nhsic(x_, z_, **kw), (x, z))]


JAX_SIDE = {"flash_attention": _jax_flash, "slstm_scan": _jax_slstm,
            "hsic_gram": _jax_nhsic}


@pytest.mark.parametrize("family", ka.FAMILIES)
def test_plain_oracles_agree_with_the_references(family):
    rng = np.random.default_rng(1_000_003 * (SEED + 1)
                                + ka.FAMILIES.index(family))
    draw, _ = ka.FUZZERS[family]
    for _ in range(2):
        d = draw(rng)
        tol = (2e-2 if d["params"].get("dtype") == "bfloat16" else 1e-3)
        ours = _torch_side(family, d)
        theirs = JAX_SIDE[family](d["arrays"], d["params"])
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            b = torch.from_numpy(np.asarray(b, np.float64))
            assert ka._rel_err(a, b) <= tol, (family, d["params"])


def test_the_fuzzer_catches_a_divergence_and_a_crash(monkeypatch):
    from repro_torch.kernels.hsic_gram import ops
    real = ops.nhsic
    monkeypatch.setattr(ops, "nhsic",
                        lambda x, z, **kw: real(x, z, **kw) * 1.01)
    report = Report()
    summary = ka.fuzz_families(report, n_cases=2, families=["hsic_gram"],
                               device="cpu")
    assert summary["hsic_gram"]["failures"] > 0
    assert {f.check for f in report.errors} == {"pallas.fuzz-mismatch"}
    assert "rel err" in report.errors[0].message

    def crash(x, z, **kw):
        raise RuntimeError("launch refused")
    monkeypatch.setattr(ops, "nhsic", crash)
    report = Report()
    summary = ka.fuzz_families(report, n_cases=ka.MAX_FUZZ_FINDINGS + 2,
                               families=["hsic_gram"], device="cpu")
    assert summary["hsic_gram"]["errors"] == ka.MAX_FUZZ_FINDINGS + 2
    errors = [f for f in report.findings if f.check == "pallas.fuzz-error"]
    assert len(errors) == ka.MAX_FUZZ_FINDINGS
    assert "launch refused" in errors[0].message
    assert report.findings[-1].severity == "warning"     # the cap's note


def test_the_real_plain_versions_pass_the_fuzzer():
    report = Report()
    summary = ka.fuzz_families(report, n_cases=2, device="cpu")
    assert report.ok() and not report.findings
    assert all(s["checks"] > 0 and s["failures"] == 0
               for s in summary.values())


@pytest.mark.parametrize("family", ka.FAMILIES)
def test_audit_cases_name_only_the_sources_kernels(family):
    ops = importlib.import_module(f"repro_torch.kernels.{family}.ops")
    kernel = importlib.import_module(f"repro_torch.kernels.{family}.kernel")
    cases = ops.AUDIT_CASES()
    ref_ops = importlib.import_module(f"repro.kernels.{family}.ops")
    assert [c.name for c in cases] == [c.name for c in ref_ops.AUDIT_CASES()]
    found = set(global_kernels(kernel.SOURCE))
    for case in cases:
        assert case.family == family and case.kernels
        assert set(case.kernels) <= found, (case.name, case.kernels)
        assert len(case.shapes) == len(case.dtypes)
    # the resource entry point lists every kernel, in RESOURCE_KERNELS'
    # order, and nothing else
    text = kernel.SOURCE.read_text()
    body = text[re.search(r"_attributes\(int\* rows", text).start():]
    listed = re.findall(r"&(\w+(?:<[^>]*>)?)\)", body[:body.index("};")])
    aliases = {"F": "float", "H": "__nv_bfloat16", "DMAX": "128"}
    listed = [re.sub(r"\b(F|H|DMAX)\b", lambda m: aliases[m.group(1)], n)
              for n in listed]
    assert listed == [n.replace(" ", "").replace(",", ", ")
                      for n in kernel.RESOURCE_KERNELS]
    assert {n.split("<")[0] for n in listed} == found


def test_kernels_need_the_card(monkeypatch):
    from repro_torch.analysis.__main__ import main
    with pytest.raises(RuntimeError, match="cpu has none"):
        ka.run_kernel_audits(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--kernels", "--fuzz", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ka.run_kernel_audits()
