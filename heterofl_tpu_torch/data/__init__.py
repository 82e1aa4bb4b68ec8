"""Data: synthetic and on-disk datasets, their normalisation statistics,
client partitioning, shard and token-row stacking."""

from .datasets import (DATASET_STATS, ArrayDataset, TokenDataset, Vocab,  # noqa: F401
                       fetch_dataset, synthetic_lm, synthetic_vision)
from .partition import iid, non_iid, span_population, split_dataset  # noqa: F401
from .pipeline import (batchify, bptt_windows, label_split_masks,  # noqa: F401
                       process_dataset, stack_client_shards, stack_client_token_rows,
                       stack_windows)
