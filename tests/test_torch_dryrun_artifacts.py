"""The port's dry-run artifact set: every (arch x shape x mesh) combination
traced by ``python -m repro_torch.launch.dryrun --sweep`` must have a
record, and each traced one its roofline and (train) collectives: the
reference's three checks (``tests/test_dryrun_artifacts.py``) on
``results/dryrun_torch/``.  Skips when the sweep has not run in this
checkout (no untagged record there: a ``--tag`` run is an ablation, not
the sweep)."""
import glob
import json
import os

import pytest

from repro_torch.configs import ARCH_IDS, SHAPES

DRYRUN = os.path.join(os.path.dirname(__file__), "..", "results",
                      "dryrun_torch")


def _records():
    recs = {}
    for p in glob.glob(os.path.join(DRYRUN, "*.json")):
        with open(p) as f:
            r = json.load(f)
        if not r.get("tag"):
            recs[(r["arch"], r["shape"], r["mesh"], r["mode"])] = r
    return recs


pytestmark = pytest.mark.skipif(
    not _records(),
    reason="dry-run sweep artifacts not present "
           "(run python -m repro_torch.launch.dryrun --sweep)")


def test_all_pairs_traced():
    recs = _records()
    missing, failed = [], []
    for arch in ARCH_IDS:
        for shape, spec in SHAPES.items():
            mode = {"train": "train", "prefill": "prefill",
                    "decode": "decode"}[spec.kind]
            for mesh in ("pod", "multipod"):
                r = recs.get((arch, shape, mesh, mode))
                if r is None:
                    missing.append((arch, shape, mesh))
                elif not r.get("ok"):
                    failed.append((arch, shape, mesh, r.get("error")))
    assert not failed, f"dry-run failures: {failed}"
    assert len(missing) < 8, f"too many missing combos: {missing}"


def test_roofline_terms_present_and_positive():
    recs = _records()
    for r in recs.values():
        if not r.get("ok"):
            continue
        rf = r["roofline"]
        assert rf["compute_s"] >= 0 and rf["memory_s"] >= 0
        assert rf["bottleneck"] in ("compute", "memory", "collective")
        assert rf["flops_per_chip"] > 0


def test_train_shapes_record_collectives():
    recs = _records()
    for (arch, _shape, _mesh, mode), r in recs.items():
        if mode == "train" and r.get("ok"):
            assert r["collectives"]["total_bytes"] > 0, \
                f"{arch} train step with zero collective traffic?"
