"""Dataset and partition on-disk formats (a copy of
``pagraph_tpu/data/formats.py``).

The reference's dataset directory contract, so PaGraph datasets drop in:

    <dataset>/
      adj.npz        scipy sparse COO adjacency, A[dst, src] (vnum x vnum)
      feat.npy       float32 [vnum, dim]      (random 600-d if absent)
      labels.npy     int64 [vnum]
      train.npy      bool [vnum] mask
      val.npy        bool [vnum] mask
      test.npy       bool [vnum] mask

Partition artifacts live in ``<dataset>/partition_<P>_<method>/``, four
files a rank:

      subadj_<r>.npz            local CSR adjacency (compact id space)
      sub_trainid_<r>.npy       train vertex ids in LOCAL space
      sub_train2fullid_<r>.npy  local -> full id map
      sub_label_<r>.npy         labels for all local vertices

The files are the JAX package's, byte for byte in layout, so a partition
written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import scipy.sparse as spsp

from ..graph import CSRGraph

DEFAULT_RANDOM_FEAT_DIM = 600  # the reference's random-feature width


@dataclasses.dataclass
class Dataset:
    graph: CSRGraph
    features: np.ndarray          # float32 [N, dim]
    labels: np.ndarray            # int64 [N]
    train_mask: np.ndarray        # bool [N]
    val_mask: np.ndarray
    test_mask: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def feat_dim(self) -> int:
        return self.features.shape[1]

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1 if len(self.labels) else 0

    @property
    def train_nids(self) -> np.ndarray:
        return np.nonzero(self.train_mask)[0].astype(np.int64)

    @property
    def val_nids(self) -> np.ndarray:
        return np.nonzero(self.val_mask)[0].astype(np.int64)

    @property
    def test_nids(self) -> np.ndarray:
        return np.nonzero(self.test_mask)[0].astype(np.int64)


def load_dataset(path: str, *, mmap_features: bool = False,
                 random_feat_dim: int = DEFAULT_RANDOM_FEAT_DIM, seed: int = 0) -> Dataset:
    """Load a dataset directory; without ``feat.npy`` the features are
    uniform random ``[N, random_feat_dim]`` from ``seed`` (the reference's
    fallback)."""
    graph = CSRGraph.from_coo(spsp.load_npz(os.path.join(path, "adj.npz")))
    feat_path = os.path.join(path, "feat.npy")
    if os.path.exists(feat_path):
        features = np.load(feat_path, mmap_mode="r" if mmap_features else None)
        if features.dtype != np.float32 and not mmap_features:
            features = features.astype(np.float32)
    else:
        rng = np.random.default_rng(seed)
        features = rng.random((graph.num_nodes, random_feat_dim), dtype=np.float32)

    def mask(name: str) -> np.ndarray:
        return np.load(os.path.join(path, f"{name}.npy")).astype(bool)

    labels = np.load(os.path.join(path, "labels.npy")).astype(np.int64)
    return Dataset(graph, features, labels, mask("train"), mask("val"), mask("test"))


def save_dataset(path: str, ds: Dataset) -> None:
    os.makedirs(path, exist_ok=True)
    spsp.save_npz(os.path.join(path, "adj.npz"), ds.graph.to_coo())
    for name, arr in (("feat", ds.features), ("labels", ds.labels), ("train", ds.train_mask),
                      ("val", ds.val_mask), ("test", ds.test_mask)):
        np.save(os.path.join(path, f"{name}.npy"), arr)


# -- partition artifacts ------------------------------------------------------

def partition_dir(dataset_path: str, num_parts: int, method: str) -> str:
    return os.path.join(dataset_path, f"partition_{num_parts}_{method}")


@dataclasses.dataclass
class PartitionArtifact:
    graph: CSRGraph               # local compact id space
    train_nids: np.ndarray        # int64, LOCAL ids
    local2full: np.ndarray        # int64 [local_vnum]
    labels: np.ndarray            # int64 [local_vnum]

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes


def save_partition(dirpath: str, rank: int, part: PartitionArtifact) -> None:
    os.makedirs(dirpath, exist_ok=True)
    n = part.graph.num_nodes
    csr = spsp.csr_matrix(
        (np.ones(part.graph.num_edges, dtype=np.float32), part.graph.indices,
         part.graph.indptr), shape=(n, n))
    spsp.save_npz(os.path.join(dirpath, f"subadj_{rank}.npz"), csr.tocoo())
    np.save(os.path.join(dirpath, f"sub_trainid_{rank}.npy"), part.train_nids)
    np.save(os.path.join(dirpath, f"sub_train2fullid_{rank}.npy"), part.local2full)
    np.save(os.path.join(dirpath, f"sub_label_{rank}.npy"), part.labels)


def load_partition(dirpath: str, rank: int) -> PartitionArtifact:
    graph = CSRGraph.from_coo(spsp.load_npz(os.path.join(dirpath, f"subadj_{rank}.npz")))

    def arr(name: str) -> np.ndarray:
        return np.load(os.path.join(dirpath, f"{name}_{rank}.npy")).astype(np.int64)

    train_nids, local2full, labels = arr("sub_trainid"), arr("sub_train2fullid"), arr("sub_label")
    if len(labels) == len(train_nids) != graph.num_nodes:
        # reference-written partitions store the train vertices' labels only:
        # scatter them into the whole local space
        full = np.zeros(graph.num_nodes, dtype=np.int64)
        full[train_nids] = labels
        labels = full
    return PartitionArtifact(graph, train_nids, local2full, labels)
