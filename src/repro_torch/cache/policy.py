"""Shape bucketing for the serving tier.

Serving traffic produces a spread of prompt lengths; tracing and planning a
fresh graph for every length would defeat the plan.  ``BucketPolicy``
coarsens a dimension before it reaches the stitched dispatch, so one
specialization serves nearby lengths.  The default rule rounds every
dimension ``>= min_dim`` up to the next power of two.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["BucketPolicy"]


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 0 else 0


@dataclass(frozen=True)
class BucketPolicy:
    """Pad-to-bucket rules applied to every node shape before keying."""

    mode: str = "pow2"        # "pow2" | "exact"
    min_dim: int = 16         # dims below this stay exact (heads, ranks, ...)

    def bucket_dim(self, d: int) -> int:
        if self.mode == "exact" or d < self.min_dim:
            return d
        return _next_pow2(d)

    def bucket_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        return tuple(self.bucket_dim(int(d)) for d in shape)
