"""Dataset container and synthetic generators."""
from .formats import Dataset
from .synthetic import random_coo, random_split_masks, rmat_coo, synthetic_dataset
