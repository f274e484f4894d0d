"""Client data partitioning: IID and Dirichlet non-IID (paper: α = 1).

Two regimes:

* **materialized** (``iid_partition`` / ``dirichlet_partition``): index
  lists over one shared dataset — O(total samples) host memory, the
  paper-scale path (10^1-10^2 clients);
* **procedural** (``ProceduralClients``): a client's shard is derived on
  demand from ``(seed, device_id)`` — class prototypes are shared across
  the population (one global task), but each client's label mixture
  (Dirichlet), sample count, and noise are deterministic per-client
  functions, so a 10^6-client population never materializes datasets and
  server memory stays O(cohort).
"""
from __future__ import annotations

import collections
from typing import List, Optional

import numpy as np


def iid_partition(seed: int, n_samples: int, n_clients: int) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n_samples)
    return [np.sort(part) for part in np.array_split(idx, n_clients)]


def dirichlet_partition(seed: int, labels: np.ndarray, n_clients: int,
                        alpha: float = 1.0,
                        min_samples: int = 2) -> List[np.ndarray]:
    """Label-Dirichlet partition (Hsu et al.): for each class, split its
    samples across clients with proportions ~ Dir(α)."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    client_idx: List[list] = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx_c = np.where(labels == c)[0]
        rng.shuffle(idx_c)
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
        for cid, part in enumerate(np.split(idx_c, cuts)):
            client_idx[cid].extend(part.tolist())
    out = []
    all_idx = np.arange(len(labels))
    for cid in range(n_clients):
        idx = np.array(sorted(client_idx[cid]), dtype=np.int64)
        if len(idx) < min_samples:       # ensure trainable clients
            extra = rng.choice(all_idx, size=min_samples - len(idx),
                               replace=False)
            idx = np.sort(np.concatenate([idx, extra]))
        out.append(idx)
    return out


# --------------------------------------------------------------------------- #
# procedural per-client data (population scale)
# --------------------------------------------------------------------------- #
class ProceduralClients:
    """Lazy ``client_id -> Batcher`` bank for population-scale FL.

    Looks like the server's materialized batcher list (``bank[cid]``,
    ``len(bank)``) but holds only the shared class prototypes plus an
    LRU-bounded dataset cache: any client's shard regenerates
    deterministically from ``(seed, cid)`` via
    ``np.random.default_rng([seed, cid])`` — stateless, so evicting and
    re-deriving a client yields byte-identical data, and a million-client
    population costs O(cohort) server memory.

    Per-client heterogeneity (all deterministic in ``cid``):
      * sample count uniform in ``samples_per_client`` (Eq. 1 weights and
        local step counts vary across the cohort);
      * label mixture ~ Dirichlet(alpha) over the shared classes
        (``alpha=None`` = IID uniform labels);
      * sample noise drawn per client.
    """

    def __init__(self, seed: int, n_clients: int, batch_size: int = 16,
                 samples_per_client=(32, 64), num_classes: int = 10,
                 image_size: int = 8, channels: int = 3,
                 alpha: Optional[float] = 1.0, noise: float = 0.35,
                 cache_size: int = 64):
        from repro_torch.data.synthetic import _low_freq_prototype
        self.seed = int(seed)
        self.n_clients = int(n_clients)
        self.batch_size = int(batch_size)
        lo, hi = ((samples_per_client, samples_per_client)
                  if np.isscalar(samples_per_client) else samples_per_client)
        self.samples_lo, self.samples_hi = int(lo), int(hi)
        self.num_classes = int(num_classes)
        self.alpha = alpha
        self.noise = float(noise)
        self.kind = "image"
        # the GLOBAL task: class prototypes + textures shared by every
        # client (per-client prototypes would mean no common function to
        # learn) — the only O(classes) state held
        rng = np.random.default_rng(seed)
        self._protos = np.stack(
            [_low_freq_prototype(rng, image_size, channels)
             for _ in range(num_classes)])
        self._tex = np.stack(
            [_low_freq_prototype(rng, image_size, channels, cutoff=9)
             for _ in range(num_classes)])
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._cache_size = int(cache_size)

    def __len__(self) -> int:
        return self.n_clients

    def num_samples(self, cid: int) -> int:
        rng = np.random.default_rng([self.seed, int(cid)])
        return int(rng.integers(self.samples_lo, self.samples_hi + 1))

    def dataset(self, cid: int):
        from repro_torch.data.synthetic import SyntheticImageDataset
        cid = int(cid)
        if not 0 <= cid < self.n_clients:
            raise IndexError(f"client {cid} outside population "
                             f"[0, {self.n_clients})")
        if cid in self._cache:
            self._cache.move_to_end(cid)
            return self._cache[cid]
        rng = np.random.default_rng([self.seed, cid])
        n = int(rng.integers(self.samples_lo, self.samples_hi + 1))
        if self.alpha is None:
            labels = rng.integers(0, self.num_classes, n).astype(np.int32)
        else:
            props = rng.dirichlet(np.full(self.num_classes, self.alpha))
            labels = rng.choice(self.num_classes, size=n,
                                p=props).astype(np.int32)
        imgs = self._protos[labels]
        imgs = imgs + self.noise * rng.standard_normal(
            imgs.shape).astype(np.float32)
        imgs = imgs + 0.5 * self._tex[labels] * rng.standard_normal(
            (n, 1, 1, 1)).astype(np.float32)
        ds = SyntheticImageDataset(imgs.astype(np.float32), labels,
                                   self.num_classes)
        self._cache[cid] = ds
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
        return ds

    def __getitem__(self, cid: int):
        """A fresh ``Batcher`` over the client's (cached) shard.  Seeded by
        ``(seed, cid)`` alone, so repeated lookups — including after cache
        eviction — replay the identical batch stream."""
        from repro_torch.data.loader import Batcher
        return Batcher(self.dataset(cid), self.batch_size,
                       seed=self.seed + int(cid), kind=self.kind)
