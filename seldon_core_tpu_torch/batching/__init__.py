"""Server-side dynamic batching."""

from seldon_core_tpu_torch.batching.batcher import (  # noqa: F401
    BatcherStats,
    DynamicBatcher,
    bucket_for,
    default_buckets,
    normalize_buckets,
)
