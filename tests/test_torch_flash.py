"""The port's flash attention against the JAX reference's, on the CPU.

The same numpy inputs go to the reference's ``flash_attention`` (its Pallas
kernel in interpret mode, small blocks so that tiles are skipped and tails
masked) and ``attention_ref``, and to the port's ``ops.flash_attention``
(on CPU tensors its kernel wrapper takes ``ref.attention_ref``) and
``attention_ref``.  Forward and gradient agree at 1e-4 of the largest entry
in f32; bf16 at 2e-2.  Cases: causal, sliding window, GQA with G in {1, 2},
Sq != Skv, and rows with no allowed key (exactly 0 on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as r_flash
from repro.kernels.flash_attention.ref import attention_ref as r_ref
from repro_torch.kernels.flash_attention import kernel as t_kernel
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.kernels.flash_attention import ref as t_ref
from repro_torch.models.attention import sdpa as t_sdpa

TOL = 1e-4

# (B, Sq, Skv, H, KV, D, causal, window)
CASES = [
    (2, 16, 16, 2, 2, 8, True, 0),       # causal, G = 1
    (2, 16, 16, 4, 2, 8, True, 0),       # causal, G = 2
    (2, 20, 20, 4, 2, 16, False, 0),     # full, G = 2, ragged tiles
    (2, 24, 24, 2, 2, 8, True, 5),       # causal + window
    (1, 32, 32, 2, 1, 8, False, 8),      # window only, G = 2
    (1, 12, 20, 2, 2, 8, True, 0),       # Sq < Skv
    (1, 20, 12, 4, 2, 8, True, 0),       # Sq > Skv
    (1, 41, 14, 2, 2, 16, True, 4),      # rows qpos >= 18 have no key
    (2, 20, 1, 4, 2, 8, True, 3),        # rows qpos >= 3 have no key
    (2, 64, 64, 6, 6, 8, False, 0),      # the shrunk ViT's shape class
]
IDS = ["B{}-Sq{}-Skv{}-H{}-KV{}-D{}-c{}-w{}".format(*c) for c in CASES]


def _inputs(case, dtype=np.float32, seed=0):
    B, Sq, Skv, H, KV, D, _, _ = case
    rng = np.random.default_rng(seed + Sq * 31 + Skv)
    q = rng.standard_normal((B, Sq, H, D)).astype(dtype)
    k = rng.standard_normal((B, Skv, KV, D)).astype(dtype)
    v = rng.standard_normal((B, Skv, KV, D)).astype(dtype)
    g = rng.standard_normal((B, Sq, H, D)).astype(dtype)
    return q, k, v, g


def _close(port, ref, tol=TOL):
    port = np.asarray(port.detach().float() if torch.is_tensor(port)
                      else port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= tol, err


def _empty_rows(case):
    _, Sq, Skv, _, _, _, causal, window = case
    q = np.arange(Sq)[:, None]
    kk = np.arange(Skv)[None, :]
    ok = np.ones((Sq, Skv), bool)
    if causal:
        ok &= kk <= q
    if window > 0:
        ok &= kk > q - window
    return ~ok.any(1)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_matches_reference(case):
    causal, window = case[6], case[7]
    q, k, v, _ = _inputs(case)
    r_out = np.asarray(r_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window,
                               block_q=8, block_kv=8, interpret=True))
    np.testing.assert_allclose(
        r_out, np.asarray(r_ref(q, k, v, causal=causal, window=window)),
        rtol=0, atol=TOL * np.abs(r_out).max())
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    t_out = t_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    _close(t_out, r_out)
    _close(t_ref.attention_ref(tq, tk, tv, causal=causal, window=window),
           r_out)
    empty = _empty_rows(case)
    assert np.all(r_out[:, empty] == 0)
    assert bool((t_out[:, torch.from_numpy(empty)] == 0).all())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gradient_matches_reference(case):
    """VJP of the flash op with one cotangent, all three inputs."""
    causal, window = case[6], case[7]
    q, k, v, g = _inputs(case)
    _, vjp = jax.vjp(
        lambda a, b, c: r_flash(a, b, c, causal=causal, window=window,
                                block_q=8, block_kv=8, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    r_grads = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = t_ops.flash_attention(*leaves, causal=causal, window=window)
    t_grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for t_g, r_g in zip(t_grads, r_grads, strict=True):
        _close(t_g, r_g)


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[7]],
                         ids=[IDS[1], IDS[3], IDS[7]])
def test_bf16_matches_reference(case):
    causal, window = case[6], case[7]
    q, k, v, _ = _inputs(case)
    bq, bk, bv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    r_out = np.asarray(r_flash(bq, bk, bv, causal=causal, window=window,
                               block_q=8, block_kv=8, interpret=True)
                       .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (bq, bk, bv))
    t_out = t_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert t_out.dtype == torch.bfloat16
    _close(t_out, r_out, tol=2e-2)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if not _empty_rows(c).any()],
                         ids=[i for c, i in zip(CASES, IDS)
                              if not _empty_rows(c).any()])
def test_plain_sdpa_matches_flash_where_no_row_is_empty(case):
    """The model's plain path (``use_flash_kernel=False``) computes the same
    attention wherever every row has an allowed key."""
    causal, window = case[6], case[7]
    q, k, v, _ = map(torch.from_numpy, _inputs(case))
    _close(t_sdpa(q, k, v, causal=causal, window=window),
           t_ref.attention_ref(q, k, v, causal=causal, window=window)
           .numpy())


def test_cpu_path_counts_no_launch_and_saves_only_qkv():
    case = CASES[1]
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(case))
    t_kernel.reset_launches()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = t_ops.flash_attention(*leaves, causal=True)
    assert [t.data_ptr() for t in out.grad_fn.saved_tensors] == \
        [t.data_ptr() for t in leaves]
    out.backward(g)
    assert t_kernel.LAUNCHES == {"flash_attention_fwd": 0}


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 4, 3, 8)
    k = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="H % KV"):
        t_kernel._shapes(q, k, k)
    with pytest.raises(ValueError, match="head dim"):
        t_kernel._shapes(torch.zeros(1, 4, 2, 130), torch.zeros(1, 4, 2, 130),
                         torch.zeros(1, 4, 2, 130))


def _tf32(x, nearest=True):
    """Float32 to TF32's 10 mantissa bits: to nearest with ties away from
    zero (as ``cvt.rna.tf32.f32`` and the flash kernel's ``split`` round),
    or truncated (as a tensor core reads an f32 register)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if nearest:
        u = u + np.uint32(0x1000)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _attention(q, k, v, product):
    """softmax(q k^T / sqrt(D)) v with both products taken by ``product``
    and the softmax in float64, so that only the products' error shows."""
    s = product(q / np.float32(np.sqrt(q.shape[-1])),
                k.transpose(0, 2, 1)).astype(np.float64)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return product(p.astype(np.float32), v).astype(np.float64)


def test_flash_kernel_needs_three_tf32_passes_at_vit_init_scale():
    """Why the flash kernel splits each operand of a tensor-core product
    (its P V) into two TF32 halves (3xTF32).  At the ViT-12's init the
    attention logits have a std of ~64 (ROADMAP, Queue 3); drawn so here,
    at the ViT-12's B=32, S=64, D=64, with both products taken each way.
    One TF32 pass misses the 1e-3 bar; the kernel's split stays within 10x
    of a plain float32 product's error."""
    rng = np.random.default_rng(0)
    B, S, D = 32, 64, 64
    q, k = (rng.standard_normal((B, S, D)).astype(np.float32) * 8
            for _ in range(2))
    v = rng.standard_normal((B, S, D)).astype(np.float32)
    logits = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k) / 8
    assert 50 < logits.std() < 80 and logits.max() > 200

    def exact(a, b):
        return a.astype(np.float64) @ b.astype(np.float64)

    def one_pass(a, b):
        return exact(_tf32(a), _tf32(b))

    def three_pass(a, b):   # the kernel's split: lo = x - hi, truncated
        ah, bh = _tf32(a), _tf32(b)
        al, bl = _tf32(a - ah, False), _tf32(b - bh, False)
        return exact(al, bh) + exact(ah, bl) + exact(ah, bh)

    def plain_f32(a, b):
        return a.astype(np.float32) @ b.astype(np.float32)

    want = _attention(q, k, v, exact)
    scale = np.abs(want).max()
    err = {name: np.abs(_attention(q, k, v, fn) - want).max() / scale
           for name, fn in [("tf32", one_pass), ("3xtf32", three_pass),
                            ("f32", plain_f32)]}
    assert err["tf32"] > 1e-3, err
    assert err["3xtf32"] <= 10 * err["f32"], err
    assert err["3xtf32"] <= 1e-4, err
