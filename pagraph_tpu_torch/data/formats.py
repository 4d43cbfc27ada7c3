"""In-memory dataset container (a copy of ``pagraph_tpu/data/formats.py``
``Dataset``; the on-disk loaders and partition artifacts are not ported yet).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..graph import CSRGraph


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
