"""Input pipeline: token shards and their native reader (``loader``)."""

from neuronx_distributed_tpu_torch.data.loader import (  # noqa: F401
    TokenShardDataset,
    write_token_shard,
)
