"""Whole NeuLite rounds: the port's server against the JAX reference's.

Two rounds on ``cnn_setup`` (ResNet18, width 0.125, 8x8, ``num_stages=2``,
so both stages run), the port started from the reference's params through
the bridge.  The reference runs its plain nHSIC (fast on CPU); the port runs
its kernel wrappers, which take ``ref.py`` on CPU tensors.

Cohorts, feasibility, step counts and upload bytes must be identical.  Loss
and the params' update (new minus start) must agree at a scale-relative
1e-3, scaled by the largest update: E local SGD steps compound the f32
differences in summation order that a single step keeps at 1e-4.
The tiny model has kinks (ReLU, clamps) where both sides' gradients jump by
~1e-2 between params 1e-6 apart, so a longer run can leave the bar on
either side; the fleet and data here keep the run short of one.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import dirichlet_partition, make_image_dataset
from repro.federated.server import FLConfig as RFLConfig
from repro.federated.server import NeuLiteServer as RServer
from repro_torch import bridge
from repro_torch.core.progressive import make_adapter as t_make_adapter
from repro_torch.federated.server import FLConfig as TFLConfig
from repro_torch.federated.server import NeuLiteServer as TServer
from repro_torch.models.cnn import CNNConfig as TConfig

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the test processes share the cores, and each
    running a pool of threads slows every one of them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-3
FL = dict(n_devices=20, clients_per_round=3, local_epochs=1, batch_size=8,
          lr=0.05, num_stages=2, mu=0.01, seed=0)


def _rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-6))


def _leaves(ref_tree, port_tree):
    r_leaves, r_def = jax.tree.flatten(jax.device_get(ref_tree))
    t_leaves, t_def = jax.tree.flatten(bridge.to_reference(port_tree))
    assert r_def == t_def
    return ([np.asarray(a, np.float64) for a in r_leaves],
            [np.asarray(b, np.float64) for b in t_leaves])


def _update_rel_err(ref_new, ref_start, port_new, port_start):
    """Largest difference of the two sides' updates (new minus start),
    over the largest entry of the reference's update."""
    r_new, t_new = _leaves(ref_new, port_new)
    r_start, t_start = _leaves(ref_start, port_start)
    r_upd = [a - s for a, s in zip(r_new, r_start)]
    t_upd = [b - s for b, s in zip(t_new, t_start)]
    scale = max(np.abs(u).max() for u in r_upd)
    assert scale > 0
    return max(float(np.abs(a - b).max())
               for a, b in zip(r_upd, t_upd, strict=True)) / scale


@pytest.fixture(scope="module")
def servers(cnn_setup):
    adapter, _, _ = cnn_setup
    ds = make_image_dataset(0, 200, num_classes=4, image_size=8)
    parts = dirichlet_partition(0, ds.labels, FL["n_devices"], alpha=1.0)
    clients = [ds.subset(p) for p in parts]
    ref = RServer(adapter, clients, RFLConfig(**FL))
    t_adapter = t_make_adapter(TConfig(name="r18", arch="resnet18",
                                       num_classes=4, image_size=8,
                                       width_mult=0.125), FL["num_stages"])
    port = TServer(t_adapter, clients, TFLConfig(**FL, use_hsic_kernel=True),
                   params=bridge.from_reference(jax.device_get(ref.params),
                                                "cpu"),
                   device="cpu")
    start = jax.device_get(ref.params)
    ref.run(2)
    port.run(2)
    return ref, port, start


def test_two_rounds_match(servers):
    ref, port, start = servers
    assert [h.stage for h in ref.history] == [0, 1]
    for rh, th in zip(ref.history, port.history, strict=True):
        assert (rh.round_idx, rh.stage, rh.n_selected, rh.n_feasible,
                rh.upload_bytes) == (th.round_idx, th.stage, th.n_selected,
                                     th.n_feasible, th.upload_bytes)
        assert rh.n_selected > 0
        assert rh.sim_time == pytest.approx(th.sim_time, rel=1e-12)
        assert np.isfinite(th.mean_loss)
        assert abs(th.mean_loss - rh.mean_loss) <= TOL * abs(rh.mean_loss)
    assert _update_rel_err(ref.params, start, port.params,
                           bridge.from_reference(start, "cpu")) <= TOL
    # both stages trained: the params moved away from the start
    r_new = jax.tree.leaves(jax.device_get(ref.params))
    r_start = jax.tree.leaves(start)
    assert max(np.abs(a - s).max() for a, s in zip(r_new, r_start)) > \
        10 * TOL * max(np.abs(s).max() for s in r_start)


def test_faulted_round_matches(servers):
    """The fault path: truncated step masks through the stacked round."""
    ref, port, _ = servers
    cohorts, faults = [0, 3, 5], [1, None, 0]
    r_out = ref.runtime.run_round(ref.params, 1, ref.batchers, cohorts, 2,
                                  faults=faults)
    t_out = port.runtime.run_round(port.params, 1, port.batchers, cohorts, 2,
                                   faults=faults)
    assert r_out.num_batches == t_out.num_batches
    assert r_out.num_samples == t_out.num_samples
    assert r_out.n_uploads == t_out.n_uploads == 2
    assert _rel_err(float(t_out.mean_loss), float(r_out.mean_loss)) <= TOL
    assert _update_rel_err(r_out.params, ref.params, t_out.params,
                           port.params) <= TOL


def test_lost_round_keeps_params(servers):
    ref, port, _ = servers
    r_out = ref.runtime.run_round(ref.params, 0, ref.batchers, [1, 2], 1,
                                  faults=[0, 0])
    t_out = port.runtime.run_round(port.params, 0, port.batchers, [1, 2], 1,
                                   faults=[0, 0])
    assert np.isnan(float(r_out.mean_loss)) and np.isnan(
        float(t_out.mean_loss))
    assert t_out.params is port.params and t_out.n_uploads == 0
    assert r_out.num_batches == t_out.num_batches


def test_evaluate_counts_on_device_and_matches(servers):
    ref, port, _ = servers
    from repro.data import Batcher as RBatcher
    from repro_torch.data.loader import Batcher as TBatcher
    ds = make_image_dataset(1, 64, num_classes=4, image_size=8)
    ref.test_batcher = RBatcher(ds, 16, seed=0)
    port.test_batcher = TBatcher(ds, 16, seed=0)
    assert port.evaluate() == ref.evaluate()


def test_port_server_defaults_to_cuda(monkeypatch, cnn_setup):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t_adapter = t_make_adapter(TConfig(name="r18", arch="resnet18",
                                       num_classes=4, image_size=8,
                                       width_mult=0.125), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TServer(t_adapter, [], TFLConfig(**FL))
