"""Hash (random-chunk) partitioner, the naive baseline (the port of
``pagraph_tpu/partition/hash_part.py``): shuffle the train vertices, chunk
them evenly, expand each chunk to its ``hops`` self-reliant closure."""
from __future__ import annotations

from typing import List

import numpy as np

from ..data.formats import PartitionArtifact
from ..graph import CSRGraph
from .utils import extract_partition


def hash_partition(graph: CSRGraph, train_nids: np.ndarray, labels: np.ndarray,
                   num_parts: int, hops: int, *, seed: int = 0) -> List[PartitionArtifact]:
    train_nids = np.asarray(train_nids, dtype=np.int64)
    shuffled = train_nids[np.random.default_rng(seed).permutation(len(train_nids))]
    return [extract_partition(graph, np.sort(chunk), labels, hops)
            for chunk in np.array_split(shuffled, num_parts)]
