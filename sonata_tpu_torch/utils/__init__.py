"""Shape bucketing shared by the batch and streaming paths."""

from .buckets import BATCH_BUCKETS, FRAME_BUCKETS, TEXT_BUCKETS, bucket_for, pad_to

__all__ = ["BATCH_BUCKETS", "FRAME_BUCKETS", "TEXT_BUCKETS", "bucket_for",
           "pad_to"]
