"""Data: synthetic vision datasets, client partitioning, shard stacking."""

from .datasets import DATASET_STATS, ArrayDataset, fetch_dataset, synthetic_vision  # noqa: F401
from .partition import iid, non_iid, split_dataset  # noqa: F401
from .pipeline import label_split_masks, stack_client_shards  # noqa: F401
