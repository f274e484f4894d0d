"""The kernels' custom ops under ``torch.func``, on the CPU (their plain
versions): each op under ``vmap`` equals a Python loop over cohorts, so
does ``vmap(grad(...))`` of nHSIC and of flash attention;
``torch.library.opcheck`` passes on each op; and on the CPU
``jit_stage_step`` and ``jit_full_step`` are the eager steps.  The sLSTM
scan's ops under ``vmap`` are held in ``tests/test_torch_xlstm_vectorized.py``.  What launches once for all cohorts
on the card is held there (``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.common.tree import tree_leaves
from repro_torch.core import curriculum as cur
from repro_torch.core import progressive as prog
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.hsic_gram import kernel, ops
from repro_torch.models.cnn import CNNConfig
from repro_torch.optim.optimizers import sgd

C, B, DX, DZ = 3, 12, 5, 7
RTOL, ATOL = 1e-5, 1e-6


def _rand(*shape, seed=0, low=None):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if low is not None:
        a = np.abs(a) + low
    return torch.from_numpy(a)


def _close(a, b):
    torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def _loop(fn, batched, shared):
    """fn applied to each cohort's slice of ``batched``, stacked."""
    outs = [fn(*(t[c] for t in batched), *shared) for c in range(C)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _op_cases():
    x, z = _rand(C, B, DX, seed=1), _rand(C, B, DZ, seed=2)
    rx, rz = _rand(C, B, seed=3, low=0.1), _rand(C, B, seed=4, low=0.1)
    return {
        "nhsic_rowsums": (kernel.nhsic_rowsums, (x, z),
                          (_rand(2, seed=5, low=0.5),)),
        "nhsic_stats_feats": (kernel.nhsic_stats_feats, (x, z, rx, rz),
                              (_rand(4, seed=6, low=0.5),)),
        "nhsic_grad": (kernel.nhsic_grad, (x, z, rx, rz),
                       (_rand(7, seed=7, low=0.5),)),
    }


@pytest.mark.parametrize("name", ["nhsic_rowsums", "nhsic_stats_feats",
                                  "nhsic_grad"])
@pytest.mark.parametrize("linear_x", [False, True], ids=["rbf", "linear"])
def test_hsic_op_under_vmap_equals_a_loop(name, linear_x):
    """The cohort axis batched on the activations (and row means), the
    scalars shared: the vmap rule expands them to the cohorts."""
    op, batched, shared = _op_cases()[name]

    def fn(*a):
        return op(*a, linear_x=linear_x)

    in_dims = (0,) * len(batched) + (None,) * len(shared)
    _close(torch.func.vmap(fn, in_dims=in_dims)(*batched, *shared),
           _loop(fn, batched, shared))


def test_hsic_op_under_vmap_on_another_axis():
    """The vmapped axis need not lead: it moves to the front."""
    op, (x, z), (s2,) = _op_cases()["nhsic_rowsums"]
    got = torch.func.vmap(op, in_dims=(1, 1, None))(x.transpose(0, 1),
                                                   z.transpose(0, 1), s2)
    _close(got, _loop(op, (x, z), (s2,)))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 3)])
def test_flash_op_under_vmap_equals_a_loop(causal, window):
    q, k, v = (_rand(C, 2, 6, 4, 8, seed=s) for s in (1, 2, 3))

    def fn(q_, k_, v_):
        return fkernel.flash_attention_fwd(q_, k_, v_, causal=causal,
                                           window=window)

    _close(torch.func.vmap(fn)(q, k, v), _loop(fn, (q, k, v), ()))
    # k and v shared by the cohorts (expanded by the rule)
    _close(torch.func.vmap(fn, in_dims=(0, None, None))(q, k[0], v[0]),
           torch.stack([fn(q[c], k[0], v[0]) for c in range(C)]))


@pytest.mark.parametrize("kx,kz", [("rbf", "rbf"), ("linear", "rbf")])
def test_vmap_grad_of_nhsic_equals_a_loop(kx, kz):
    x, z = _rand(C, B, DX, seed=8), _rand(C, B, DZ, seed=9)

    def f(x_, z_):
        return ops.nhsic(x_, z_, kernel_x=kx, kernel_z=kz)

    grad = torch.func.grad_and_value(f, argnums=(0, 1))
    (gx, gz), val = torch.func.vmap(grad)(x, z)
    want = [grad(x[c], z[c]) for c in range(C)]
    _close(val, torch.stack([w[1] for w in want]))
    _close(gx, torch.stack([w[0][0] for w in want]))
    _close(gz, torch.stack([w[0][1] for w in want]))
    # and the plain nHSIC's gradient, which the kernels' backward replaces
    plain = torch.func.grad(
        lambda a, b: cur.hsic.nhsic(a, b, kernel_x=kx, kernel_z=kz),
        argnums=(0, 1))
    for c in range(C):
        px, pz = plain(x[c], z[c])
        torch.testing.assert_close(gx[c], px, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(gz[c], pz, rtol=1e-4, atol=1e-6)


def test_vmap_grad_of_flash_attention_equals_a_loop():
    q, k, v = (_rand(C, 2, 6, 4, 8, seed=s) for s in (4, 5, 6))

    def f(q_, k_, v_):
        return fops.flash_attention(q_, k_, v_, causal=True).square().sum()

    grad = torch.func.grad(f, argnums=(0, 1, 2))
    got = torch.func.vmap(grad)(q, k, v)
    want = [grad(q[c], k[c], v[c]) for c in range(C)]
    for g, w in zip(got, zip(*want)):
        _close(g, torch.stack(w))


OPCHECK = {
    "nhsic_rowsums": lambda: (kernel.nhsic_rowsums,
                              _op_cases()["nhsic_rowsums"]),
    "nhsic_stats_feats": lambda: (kernel.nhsic_stats_feats,
                                  _op_cases()["nhsic_stats_feats"]),
    "nhsic_grad": lambda: (kernel.nhsic_grad, _op_cases()["nhsic_grad"]),
}


@pytest.mark.parametrize("name", list(OPCHECK) + ["flash_attention_fwd"])
def test_opcheck(name):
    """Schema, fake (meta) implementation, dispatch and autograd
    registration of each op, unbatched and with a cohort axis."""
    if name == "flash_attention_fwd":
        q, k, v = (_rand(2, 6, 4, 8, seed=s) for s in (1, 2, 3))
        torch.library.opcheck(fkernel.flash_attention_fwd, (q, k, v),
                              {"causal": True, "window": 0})
        return
    op, (_, batched, shared) = OPCHECK[name]()
    s = shared[0]
    torch.library.opcheck(op, (*(t[0] for t in batched), s),
                          {"linear_x": True})
    torch.library.opcheck(op, (*batched, s.expand(C, *s.shape).clone()))


@pytest.fixture(scope="module")
def cnn():
    adapter = prog.make_adapter(CNNConfig(name="r", arch="resnet18",
                                          num_classes=4, image_size=8,
                                          width_mult=0.125), 2)
    params = adapter.init_params(0, "cpu")
    rng = np.random.default_rng(0)
    batch = {"inputs": {"images": torch.from_numpy(rng.standard_normal(
        (8, 8, 8, 3)).astype(np.float32))},
        "labels": torch.from_numpy(rng.integers(0, 4, 8).astype(np.int32))}
    return adapter, params, batch


def test_jit_steps_on_the_cpu_are_the_eager_steps(cnn):
    adapter, params, batch = cnn
    opt, hp = sgd(0.05), cur.CurriculumHP(use_hsic_kernel=True)
    assert not prog.donation_supported("cpu")
    frozen, trainable = adapter.split_stage(params, 1)
    step = prog.jit_stage_step(adapter, opt, hp, 1, device="cpu")
    eager = prog.make_stage_step(adapter, opt, hp, 1)
    assert not isinstance(step, prog.CapturedStep)
    a = step(opt.init(trainable), trainable, frozen, batch, trainable)
    b = eager(opt.init(trainable), trainable, frozen, batch, trainable)
    for x, y in zip(tree_leaves(a[:2]), tree_leaves(b[:2])):
        assert torch.equal(x, y)
    assert torch.equal(a[2]["loss"], b[2]["loss"])
    assert prog.own_outputs(step, a[1]) is a[1]
    full = prog.jit_full_step(adapter, opt, device="cpu")
    model = {"model": params["model"]}
    c = full(opt.init(model), model, batch)
    d = prog.make_full_step(adapter, opt)(opt.init(model), model, batch)
    assert torch.equal(c[2]["loss"], d[2]["loss"])
