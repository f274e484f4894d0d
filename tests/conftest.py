import os
import sys

# tests run single-device (the dry-run alone uses 512 placeholder devices —
# it sets XLA_FLAGS itself, in a subprocess)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    # Degrade property tests to a few seeded examples when hypothesis is
    # absent (e.g. this offline container; CI installs the real package)
    # instead of failing collection.
    import random
    import types

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def _given(*args, **kw):
        if args:
            raise TypeError("shim supports keyword strategies only")

        def deco(fn):
            # zero-arg wrapper (no functools.wraps): pytest must not see the
            # strategy parameters, or it would resolve them as fixtures
            def wrapper():
                rng = random.Random(0)
                for _ in range(3):
                    fn(**{n: s.draw(rng) for n, s in kw.items()})
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            return wrapper
        return deco

    def _settings(*args, **kw):
        def deco(fn):
            return fn
        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = lambda lo, hi: _Strategy(lambda r: r.randint(lo, hi))
    _st.floats = lambda lo, hi: _Strategy(lambda r: r.uniform(lo, hi))
    _st.booleans = lambda: _Strategy(lambda r: bool(r.getrandbits(1)))
    _st.sampled_from = \
        lambda xs: _Strategy(lambda r, xs=list(xs): r.choice(xs))
    _st.lists = lambda elem, min_size=0, max_size=6: _Strategy(
        lambda r: [elem.draw(r)
                   for _ in range(r.randint(min_size, max_size))])

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "slow: long-running integration test")
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skips without one")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


@pytest.fixture()
def np_rng():
    return np.random.default_rng(0)


# --------------------------------------------------------------------------- #
# shared FL fixtures (module-scoped: each test module gets its own adapter /
# params / batchers, so per-module rng state stays independent)
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def cnn_setup():
    """Tiny ResNet18 adapter + params + 4 non-IID client batchers."""
    from repro.core import make_adapter
    from repro.data import Batcher, dirichlet_partition, make_image_dataset
    from repro.models.cnn import CNNConfig

    ccfg = CNNConfig(name="r18", arch="resnet18", num_classes=4,
                     image_size=8, width_mult=0.125)
    adapter = make_adapter(ccfg, 2)
    params = adapter.init_params(jax.random.PRNGKey(0))
    ds = make_image_dataset(0, 200, num_classes=4, image_size=8)
    parts = dirichlet_partition(0, ds.labels, 4, alpha=1.0)
    batchers = [Batcher(ds.subset(p), 16, seed=i, kind="image")
                for i, p in enumerate(parts)]
    return adapter, params, batchers


@pytest.fixture(scope="module")
def tx_setup():
    """Tiny dense transformer adapter + params + 3 client batchers."""
    from repro.core import make_transformer_adapter
    from repro.data import Batcher, make_lm_dataset
    from repro.models.config import ModelConfig

    cfg = ModelConfig(name="t", family="dense", num_layers=4, d_model=32,
                      num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
                      dtype="float32")
    adapter = make_transformer_adapter(cfg, 2)
    params = adapter.init_params(jax.random.PRNGKey(0))
    ds = make_lm_dataset(0, 96, 8, cfg.vocab_size)
    idx = np.arange(len(ds))
    batchers = [Batcher(ds.subset(idx[i::3]), 8, seed=i, kind="lm")
                for i in range(3)]
    return adapter, params, batchers
