"""The paper's core experiment at example scale: NeuLite against FedAvg,
ExclusiveFL and DepthFL on a heterogeneous 30-device fleet (ResNet18 at
width 0.5, non-IID synthetic CIFAR-like data); port of the reference's
``examples/federated_heterogeneous.py``.

It shows the qualitative Table 1 story: NeuLite keeps every device in the
round under the memory wall while the exclusive baselines drop most.

  PYTHONPATH=src python -m repro_torch.examples.federated_heterogeneous

Environment knobs:

  FEDHET_ROUNDS=N          round budget (default 6)
  FEDHET_SELECTION=POLICY  run ONLY NeuLite with that cohort policy
                           ("random" | "tifl" | "oort"), skipping the
                           baselines
  FEDHET_DEVICE=DEV        torch device (default: the CUDA card; "cpu")
"""
import os

from repro_torch.core.progressive import make_adapter
from repro_torch.data.loader import Batcher
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.federated.baselines import DepthFL, ExclusiveFL, FedAvg
from repro_torch.federated.server import FLConfig, NeuLiteServer
from repro_torch.models.cnn import CNNConfig


def main():
    rounds = int(os.environ.get("FEDHET_ROUNDS", "6"))
    selection = os.environ.get("FEDHET_SELECTION", "")
    device = os.environ.get("FEDHET_DEVICE") or None
    ds = make_image_dataset(0, 3000, num_classes=10, image_size=16)
    test = make_image_dataset(1, 512, num_classes=10, image_size=16)
    parts = dirichlet_partition(0, ds.labels, 30, alpha=1.0)
    clients = [ds.subset(p) for p in parts]
    ccfg = CNNConfig(name="resnet18", arch="resnet18", image_size=16,
                     width_mult=0.5)
    # runtime: "sequential" (clients one by one, captured steps on the
    # card) or "vectorized" (the whole cohort as one vmapped step);
    # selection: the round-open cohort policy over the streaming fleet,
    # "random" (the paper's memory-feasible uniform rule), "tifl" or "oort"
    flc = FLConfig(n_devices=30, clients_per_round=5, local_epochs=1,
                   batch_size=32, num_stages=4, seed=0, rounds_per_stage=2,
                   runtime="sequential", selection=selection or "random")

    print(f"== NeuLite (progressive, curriculum, "
          f"selection={flc.selection}) ==")
    srv = NeuLiteServer(make_adapter(ccfg, flc.num_stages), clients, flc,
                        test_batcher=Batcher(test, 128, kind="image"),
                        device=device)
    hist = srv.run(rounds, log_every=1)
    print(f"NeuLite: acc={hist[-1].test_acc:.3f} "
          f"participation={srv.participation_rate:.0%}\n")

    if not selection:
        for cls in (FedAvg, ExclusiveFL, DepthFL):
            b = cls(ccfg, clients, Batcher(test, 128, kind="image"), flc,
                    device=device)
            res = b.run(rounds)
            print(f"{res.name:12s}: acc={res.accuracies[-1]:.3f} "
                  f"participation={res.participation_rate:.0%}")


if __name__ == "__main__":
    main()
