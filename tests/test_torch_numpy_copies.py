"""The port's numpy-only copies (data, PRNG, plans, schedules, fleet,
selection) give byte-identical output to the reference for the same
seeds."""
import numpy as np
import pytest

import repro.common.prng as r_prng
import repro.core.blocks as r_blocks
import repro.core.schedule as r_sched
import repro.data.loader as r_loader
import repro.data.partition as r_part
import repro.data.synthetic as r_syn
import repro.federated.devices as r_dev
import repro.federated.selection as r_sel
import repro_torch.common.prng as t_prng
import repro_torch.core.blocks as t_blocks
import repro_torch.core.schedule as t_sched
import repro_torch.data.loader as t_loader
import repro_torch.data.partition as t_part
import repro_torch.data.synthetic as t_syn
import repro_torch.federated.devices as t_dev
import repro_torch.federated.selection as t_sel


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7])
def test_prng_identical(seed):
    ids = np.arange(1000)
    np.testing.assert_array_equal(r_prng.hash_u64(seed, ids, 3),
                                  t_prng.hash_u64(seed, ids, 3))
    np.testing.assert_array_equal(r_prng.uniform01(seed, ids),
                                  t_prng.uniform01(seed, ids))
    np.testing.assert_array_equal(r_prng.permute_index(seed, ids, 1000),
                                  t_prng.permute_index(seed, ids, 1000))


@pytest.mark.parametrize("seed,n_clients", [(0, 4), (3, 10)])
def test_dataset_partitions_and_batches_identical(seed, n_clients):
    rds = r_syn.make_image_dataset(seed, 120, num_classes=4, image_size=8)
    tds = t_syn.make_image_dataset(seed, 120, num_classes=4, image_size=8)
    np.testing.assert_array_equal(rds.images, tds.images)
    np.testing.assert_array_equal(rds.labels, tds.labels)
    rparts = r_part.dirichlet_partition(seed, rds.labels, n_clients)
    tparts = t_part.dirichlet_partition(seed, tds.labels, n_clients)
    for a, b in zip(rparts, tparts, strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(r_part.iid_partition(seed, 120, 3)[1],
                                  t_part.iid_partition(seed, 120, 3)[1])
    rb = [r_loader.Batcher(rds.subset(p), 8, seed=i)
          for i, p in enumerate(rparts)]
    tb = [t_loader.Batcher(tds.subset(p), 8, seed=i)
          for i, p in enumerate(tparts)]
    for a, b in zip(rb[0].epoch(), tb[0].epoch(), strict=True):
        _assert_tree_equal(a, b)
    rstack = r_loader.stack_round(rb, [0, 1], local_epochs=2)
    tstack = t_loader.stack_round(tb, [0, 1], local_epochs=2)
    _assert_tree_equal(rstack.batches, tstack.batches)
    np.testing.assert_array_equal(rstack.step_mask, tstack.step_mask)
    np.testing.assert_array_equal(rstack.weights, tstack.weights)
    assert rstack.num_batches == tstack.num_batches
    faults = [1, None]
    rt = r_loader.truncate_step_mask(rstack, faults)
    tt = t_loader.truncate_step_mask(tstack, faults)
    np.testing.assert_array_equal(rt.step_mask, tt.step_mask)
    np.testing.assert_array_equal(rt.weights, tt.weights)
    assert rt.num_batches == tt.num_batches


def test_procedural_clients_identical():
    rc = r_part.ProceduralClients(5, 1000, batch_size=8)
    tc = t_part.ProceduralClients(5, 1000, batch_size=8)
    for cid in (0, 17, 999):
        _assert_tree_equal(next(rc[cid].epoch()), next(tc[cid].epoch()))


@pytest.mark.parametrize("units,stages,boundary", [(9, 4, 1), (9, 2, 1),
                                                   (17, 4, 2), (3, 5, 1)])
def test_plans_identical(units, stages, boundary):
    rp = r_blocks.make_plan(units, stages, boundary)
    tp = t_blocks.make_plan(units, stages, boundary)
    assert rp.bounds == tp.bounds
    for t in range(rp.num_stages):
        assert rp.stage_ranges(t) == tp.stage_ranges(t)


def test_stage_sequences_identical():
    metrics = [1.0, 0.9, 0.9, 0.9, 0.9, float("nan"), 0.5, 0.5, 0.5, 0.5]
    pairs = [(r_sched.RoundRobinSchedule(4), t_sched.RoundRobinSchedule(4)),
             (r_sched.SequentialSchedule(4, 3),
              t_sched.SequentialSchedule(4, 3)),
             (r_sched.PlateauSchedule(4, patience=2),
              t_sched.PlateauSchedule(4, patience=2))]
    for rs, ts in pairs:
        seq_r, seq_t = [], []
        for r, m in enumerate(metrics):
            seq_r.append(rs.stage(r))
            seq_t.append(ts.stage(r))
            rs.observe(r, m)
            ts.observe(r, m)
        assert seq_r == seq_t


@pytest.mark.parametrize("n_devices", [100, 10000])
def test_fleet_and_random_cohorts_identical(n_devices):
    rf = r_dev.Fleet(0, n_devices, 10 ** 9)
    tf = t_dev.Fleet(0, n_devices, 10 ** 9)
    ids = np.arange(min(n_devices, 500))
    np.testing.assert_array_equal(rf.mem_bytes(ids), tf.mem_bytes(ids))
    np.testing.assert_array_equal(rf.speeds(ids), tf.speeds(ids))
    np.testing.assert_array_equal(rf.tier_of(ids), tf.tier_of(ids))
    rrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    rpol, tpol = r_sel.make_policy("random"), t_sel.make_policy("random")
    for r, req in enumerate([2 * 10 ** 8, 6 * 10 ** 8, 10 ** 9, 2 * 10 ** 9]):
        assert (rpol.select(rrng, rf, 10, req, r)
                == tpol.select(trng, tf, 10, req, r))
