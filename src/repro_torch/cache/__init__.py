"""Shape bucketing (the plan cache itself is not ported yet)."""

from .policy import BucketPolicy

__all__ = ["BucketPolicy"]
