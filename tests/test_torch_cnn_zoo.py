"""The paper's VGG11 and SqueezeNet in the port against the JAX reference:
each unit (pooling and not), the skip of a pool once the map is spatially
flat, the forward (shrunk, and once at full width), one NeuLite step per
stage, the bridge of a fire module's convs, and the memory model of the
four CNNs at full width to the byte.

Inputs are numpy draws from fixed seeds; params are the port's init from
seed 0, bridged to the reference (its own init traces every leaf: ~10 s
a model on the CPU).  Tolerance: f32 at rtol 1e-4 (the reference's own
backend-equivalence bar), with an absolute floor of 1e-4 of the largest
entry (of a step's largest update, for a step).  A step's bar takes the
reference's own sensitivity into account, as ``chip_smoke.py``'s step check
does: the reference steps again from its frozen prefix and start tree
times 1 + 1e-7 N(0, 1) (a seeded draw per entry), and where that moves its
update by more than 1e-5 of its largest entry, the bar is 10 times the
movement (and must stay below 2e-3, just above the 1.9e-3 that
SqueezeNet's stage 1 reaches, so that a noisier reference cannot widen
the bar unseen).  SqueezeNet's stage 1 is such a step
at every batch and shrink tried (seeds 0-3 at 16x16 and width 0.125, width
0.25, 32x32): its nHSIC of a 16-channel embedding moves the update by
1.2e-4 to 3e-4 of its largest entry for a change of the frozen prefix
alone, and the port's prefix differs from XLA's by rounding.  The shrunk
fixtures are
width 0.125 (4 classes): VGG11 at 8x8, so that it reaches a 1x1 map after
its fourth unit and skips its last two pools; SqueezeNet at 16x16.  At
8x8 SqueezeNet's last fire module would see a 1x1 map with one channel
per GroupNorm group: each group normalises a single value, which the
reference gives as exactly 0 and ``F.group_norm`` as rounding noise
(1e-5), so the reference's logits are identically 0 there and hold the
port to nothing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as r_optim
from repro.common import paramdef as r_pd
from repro.core import make_adapter as r_make_adapter
from repro.core import memory as r_mem
from repro.core.curriculum import CurriculumHP as RHP
from repro.core.progressive import make_stage_step as r_make_step
from repro.data import make_image_dataset
from repro.models import cnn as r_cnn
from repro_torch import bridge
from repro_torch.common import paramdef as t_pd
from repro_torch.configs import paper_models as t_zoo
from repro_torch.core import memory as t_mem
from repro_torch.core.curriculum import CurriculumHP as THP
from repro_torch.core.progressive import make_adapter as t_make_adapter
from repro_torch.core.progressive import make_stage_step as t_make_step
from repro_torch.models import cnn as t_cnn
from repro_torch.optim.optimizers import sgd as t_sgd

RTOL = 1e-4
STEP_BAR_CAP = 2e-3     # the largest bar reached: 1.9e-3
ARCHS = ("vgg11", "squeezenet")
SMALL = dict(num_classes=4, width_mult=0.125)
IMAGE = {"vgg11": 8, "squeezenet": 16}


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                      np.float64)


def _close(ref, port, rtol=RTOL, scale=None):
    ref, port = _np(ref), _np(port)
    assert ref.shape == port.shape
    if scale is None:
        scale = np.abs(ref).max()
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(scale, 1e-6))


def _models(arch, stages=4, **kw):
    """Both sides' adapters for ``arch``, and the port's init as both
    sides' params."""
    kw = {**SMALL, "image_size": IMAGE[arch], **kw}
    adapter = r_make_adapter(r_cnn.CNNConfig(name=arch, arch=arch, **kw),
                             stages)
    t_adapter = t_make_adapter(t_cnn.CNNConfig(name=arch, arch=arch, **kw),
                               stages)
    t_params = t_adapter.init_params(0, "cpu")
    return adapter, bridge.to_reference(t_params), t_adapter, t_params


def _batches(n, size, classes, seed=0):
    ds = make_image_dataset(seed, n, num_classes=classes, image_size=size)
    r = {"inputs": {"images": jnp.asarray(ds.images)},
         "labels": jnp.asarray(ds.labels)}
    t = {"inputs": {"images": torch.from_numpy(ds.images)},
         "labels": torch.from_numpy(ds.labels)}
    return r, t


@pytest.fixture(scope="module")
def models():
    return {arch: _models(arch) for arch in ARCHS}


@pytest.fixture(scope="module", params=ARCHS)
def zoo(request, models):
    return (request.param, *models[request.param])


def test_configs_build_the_reference_units():
    from repro.configs import paper_models as r_zoo
    for arch in ARCHS:
        r, t = getattr(r_zoo, arch)(), getattr(t_zoo, arch)()
        assert (t.name, t.arch, t.num_classes, t.image_size) == (
            r.name, r.arch, r.num_classes, r.image_size)
        assert t_cnn.unit_meta(t) == r_cnn.unit_meta(r)


@pytest.mark.parametrize("arch,unit", [("vgg11", i) for i in range(8)]
                         + [("squeezenet", i) for i in range(9)])
def test_unit_matches(models, arch, unit):
    """One unit on a 5x5 map: a pooling unit floors 5 to 2, as the
    reference's VALID ``reduce_window`` does."""
    adapter, params, t_adapter, t_params = models[arch]
    kind, meta = r_cnn.unit_meta(adapter.cfg)[unit]
    rng = np.random.default_rng(unit)
    x = rng.standard_normal((2, 5, 5, meta["cin"])).astype(np.float32)
    want = r_cnn._unit_apply(kind, meta, params["model"]["units"][unit],
                             jnp.asarray(x), adapter.cfg.groups, "lax")
    got = t_cnn._unit_apply(kind, meta, t_params["model"]["units"][unit],
                            t_cnn.nchw(torch.from_numpy(x)),
                            t_adapter.cfg.groups)
    assert want.shape[1] == (2 if meta["stride"] == 2 else 5)
    _close(want, t_cnn.nhwc(got))


def test_vgg_skips_its_pool_once_spatially_flat(models):
    """VGG11 at 8x8 pools 8 -> 4 -> 2 -> 1 and then meets two more pooling
    units on a 1x1 map: both pass it on unpooled (the flat test reads H,
    axis 2 of an NCHW map, not the channel count)."""
    adapter, params, t_adapter, t_params = models["vgg11"]
    metas = t_cnn.unit_meta(t_adapter.cfg)
    x_np = np.random.default_rng(0).standard_normal(
        (2, 8, 8, 3)).astype(np.float32)
    x, xr, sizes = t_cnn.nchw(torch.from_numpy(x_np)), jnp.asarray(x_np), []
    for i, (kind, meta) in enumerate(metas):
        flat = x.shape[2] < 2
        x = t_cnn._unit_apply(kind, meta, t_params["model"]["units"][i], x,
                              t_adapter.cfg.groups)
        xr = r_cnn._unit_apply(kind, meta, params["model"]["units"][i], xr,
                               adapter.cfg.groups, "lax")
        _close(xr, t_cnn.nhwc(x))
        if flat:
            assert meta["stride"] in (1, 2) and x.shape[2:] == (1, 1)
        sizes.append(x.shape[2])
    assert sizes == [4, 2, 2, 1, 1, 1, 1, 1]
    assert [m["stride"] for _, m in metas[5:]] == [2, 1, 2]


def test_forward_matches_shrunk(zoo):
    arch, adapter, params, t_adapter, t_params = zoo
    r_batch, t_batch = _batches(8, IMAGE[arch], 4)
    _close(adapter.forward_eval(params, r_batch["inputs"]),
           t_adapter.forward_eval(t_params, t_batch["inputs"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_full_width(arch):
    """The paper's widths: 32x32x3, 10 classes, batch 2."""
    adapter, params, t_adapter, t_params = _models(
        arch, num_classes=10, image_size=32, width_mult=1.0)
    r_batch, t_batch = _batches(2, 32, 10, seed=1)
    want = jax.jit(r_cnn.cnn_forward, static_argnums=1)(
        params["model"], adapter.cfg, r_batch["inputs"]["images"])
    got = t_cnn.cnn_forward(t_params["model"], t_adapter.cfg,
                            t_batch["inputs"]["images"])
    assert got.shape == (2, 10)
    _close(want, got)
    _close(r_cnn.cnn_loss(params["model"], adapter.cfg, r_batch),
           t_cnn.cnn_loss(t_params["model"], t_adapter.cfg, t_batch))


def _update(new, start):
    return [np.asarray(a, np.float64) - s
            for a, s in zip(jax.tree.leaves(new), start)]


@pytest.fixture(scope="module")
def ref_steps(zoo):
    """The reference's step of every stage from a start tree 1.01x the
    global ref (so the proximal term is nonzero), on one batch of 16; and
    how far its own update moves when the frozen prefix and the start tree
    move by a random 1e-7 relative change, relative to the update's
    largest entry."""
    arch, adapter, params, _, _ = zoo
    r_batch, t_batch = _batches(16, IMAGE[arch], 4, seed=2)
    opt = r_optim.sgd(0.05)
    out = {}
    for t in range(4):
        step = jax.jit(r_make_step(adapter, opt, RHP(mu=0.01), t))
        rf, rt = adapter.split_stage(params, t)
        rt1 = jax.tree.map(lambda a: a * 1.01, rt)
        start = jax.tree.leaves(jax.device_get(rt1))
        _, r_new, r_m = step(opt.init(rt1), rt1, rf, r_batch, rt)
        rng = np.random.default_rng(t)

        def eps(tree):
            return jax.tree.map(lambda a: (np.asarray(a) * (
                1 + 1e-7 * rng.standard_normal(np.shape(a)))).astype(
                    np.float32), tree)

        _, r_eps, _ = step(opt.init(rt1), eps(rt1), eps(rf), r_batch, rt)
        upd, moved = _update(r_new, start), _update(r_eps, start)
        scale = max(np.abs(u).max() for u in upd if u.size)
        sens = max(float(np.abs(a - b).max()) for a, b in zip(upd, moved)
                   if a.size) / scale
        out[t] = (rt1, jax.device_get(r_new), jax.device_get(r_m), sens)
    return arch, t_batch, out


@pytest.mark.parametrize("t", [0, 1, 2, 3])
def test_stage_step_matches(zoo, ref_steps, t):
    """Loss, metrics and the update of every trainable leaf, nHSIC through
    the kernel wrapper (its plain version on CPU tensors)."""
    _, _, _, t_adapter, t_params = zoo
    _, t_batch, steps = ref_steps
    rt1, r_new, r_m, sens = steps[t]
    bar = RTOL if sens <= RTOL / 10 else max(RTOL, 10 * sens)
    assert bar < STEP_BAR_CAP, (
        f"the reference differs from itself by {sens:.1e}")
    opt = t_sgd(0.05)
    step = t_make_step(t_adapter, opt, THP(mu=0.01, use_hsic_kernel=True), t)
    tf, tt = t_adapter.split_stage(t_params, t)
    tt1 = bridge.from_reference(jax.device_get(rt1), "cpu")
    _, t_new, t_m = step(opt.init(tt1), tt1, tf, t_batch, tt)
    assert set(r_m) == set(t_m)
    for k in r_m:
        _close(r_m[k], torch.as_tensor(t_m[k]))
    start = jax.tree.leaves(jax.device_get(rt1))
    r_leaves, r_def = jax.tree.flatten(r_new)
    t_leaves, t_def = jax.tree.flatten(bridge.to_reference(t_new))
    assert r_def == t_def
    r_upd = [np.asarray(a, np.float64) - s for a, s in zip(r_leaves, start)]
    t_upd = [np.asarray(b, np.float64) - s for b, s in zip(t_leaves, start)]
    scale = max(np.abs(u).max() for u in r_upd if u.size)
    assert scale > 0
    for a, b in zip(r_upd, t_upd, strict=True):
        _close(a, b, rtol=bar, scale=scale)


def test_bridge_permutes_fire_convs_exactly(models):
    """A SqueezeNet tree crosses both ways bit for bit, and each fire
    module's squeeze, e1 and e3 weights arrive OIHW."""
    _, params, _, t_params = models["squeezenet"]
    ref_np = jax.device_get(params)
    for i in range(1, 9):
        for key in ("squeeze", "e1", "e3"):
            w = np.asarray(ref_np["model"]["units"][i][key]["w"])
            got = t_params["model"]["units"][i][key]["w"].numpy()
            np.testing.assert_array_equal(got, w.transpose(3, 2, 0, 1))
    back = bridge.to_reference(t_params)
    ref_leaves, ref_def = jax.tree.flatten(ref_np)
    back_leaves, back_def = jax.tree.flatten(back)
    assert ref_def == back_def
    for a, b in zip(ref_leaves, back_leaves, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "vgg11",
                                  "squeezenet"])
def test_memory_model_identical_at_the_papers_batch(arch):
    """Fig. 6's analytic table: full width, B = 128, 4 stages."""
    ra = r_make_adapter(r_cnn.CNNConfig(name=arch, arch=arch), 4)
    ta = t_make_adapter(t_cnn.CNNConfig(name=arch, arch=arch), 4)
    assert r_pd.nbytes(ra.defs) == t_pd.nbytes(ta.defs)
    assert r_pd.nparams(ra.defs) == t_pd.nparams(ta.defs)
    fields = ("params_bytes", "grads_bytes", "opt_bytes", "act_bytes")
    r_tab = r_mem.stage_memory_table(ra, 128)
    t_tab = t_mem.stage_memory_table(ta, 128)
    assert len(t_tab) == 4
    for r_est, t_est in zip(r_tab, t_tab, strict=True):
        assert [getattr(t_est, f) for f in fields] == [
            getattr(r_est, f) for f in fields]
    r_full = r_mem.estimate_full_memory(ra, 128)
    t_full = t_mem.estimate_full_memory(ta, 128)
    assert [getattr(t_full, f) for f in fields] == [
        getattr(r_full, f) for f in fields]

