"""Sampling: fixed-shape minibatch IR, host neighbor sampler, loader."""
from .block import Block, MiniBatch
from .loader import PrefetchLoader
from .sampler import NeighborSampler, sample_minibatch
