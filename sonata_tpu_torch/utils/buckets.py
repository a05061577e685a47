"""Static-shape bucketing.

The PyTorch port keeps the JAX package's buckets: sequences pad up to the
next bucket and masks carry the true lengths, so the port sees the same
shapes as the reference (and a later CUDA-graph capture a bounded set).
"""

from __future__ import annotations

TEXT_BUCKETS = (16, 32, 64, 96, 128, 192, 256, 384, 512)
FRAME_BUCKETS = (64, 128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def bucket_for(n: int, buckets=TEXT_BUCKETS) -> int:
    """Smallest bucket ≥ n; multiples of the largest bucket if beyond."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top


def pad_to(seq, length: int, value=0):
    """Pad a python list to ``length``."""
    return list(seq) + [value] * (length - len(seq))


def canonical_dispatch_batch(max_batch: int) -> int:
    """Canonical batch size for a coalesced dispatch group.

    The stream coalescers pad every multi-request group to ONE batch
    size so the shapes each stage sees are exactly {1, max} — that size
    must be a :data:`BATCH_BUCKETS` bucket.  Used by
    :mod:`.dispatch_policy` when deriving coalescer knobs.
    """
    return bucket_for(max(int(max_batch), 1), BATCH_BUCKETS)

