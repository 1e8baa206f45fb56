"""Cache policies: shape bucketing + eviction.

Shape bucketing (the dynamic-shape story): serving traffic produces a spread
of sequence lengths; compiling a fresh plan for every length would defeat
the cache.  ``BucketPolicy`` coarsens each shape before it enters the cache
key, so a plan compiled at one length serves nearby lengths.  The default
rule rounds every dimension ``>= min_dim`` up to the next power of two —
symmetric across dims, so derived shapes (reduction outputs, broadcasts)
bucket consistently with their parents and the per-node shape tuple of two
nearby-length traces digests identically.  The serving engine applies the
same rule to prompt lengths (``serve.engine.ADMISSION_BUCKET``).

Replay at a different concrete shape inside the bucket is always *valid*
(plans are structural); per-kernel row blocks are re-clamped to the new
row count when the stitched callable is instantiated.

Eviction: the in-memory tier is a plain LRU bounded by entry count — plan
records are tiny (KBs); the bound exists to keep a long-lived serving
process from accumulating one entry per (model x bucket) forever.  The disk
tier is unbounded by default (one small JSON per entry) with an optional
``max_entries`` pruned oldest-first on insert.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["BucketPolicy", "EvictionPolicy", "BucketStats"]


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


@dataclass(frozen=True)
class EvictionPolicy:
    memory_entries: int = 128       # in-memory LRU capacity
    disk_entries: int | None = None  # None = unbounded


@dataclass
class BucketStats:
    """Per-bucket hit/miss accounting (observability for the serving tier).

    Lookups also aggregate per *placement* (``""`` for a plain
    single-device compile, ``<name>@<digest>`` for a respecialized input
    signature such as one prefill bucket) so a server can see which
    specialization is cold.
    """

    hits: dict[str, int] = field(default_factory=dict)
    misses: dict[str, int] = field(default_factory=dict)
    placement_hits: dict[str, int] = field(default_factory=dict)
    placement_misses: dict[str, int] = field(default_factory=dict)
    # unreadable record files per bucket (disk JSON corruption read as a miss)
    corrupt: dict[str, int] = field(default_factory=dict)
    # records demoted to a miss by replay verification (repro_torch.analysis)
    demoted: dict[str, int] = field(default_factory=dict)

    def record(self, bucket: str, hit: bool, placement: str = "") -> None:
        d = self.hits if hit else self.misses
        d[bucket] = d.get(bucket, 0) + 1
        p = self.placement_hits if hit else self.placement_misses
        label = placement or "single-device"
        p[label] = p.get(label, 0) + 1

    def record_corrupt(self, bucket: str) -> None:
        self.corrupt[bucket] = self.corrupt.get(bucket, 0) + 1

    def record_demoted(self, bucket: str) -> None:
        self.demoted[bucket] = self.demoted.get(bucket, 0) + 1

    @property
    def total_hits(self) -> int:
        return sum(self.hits.values())

    @property
    def total_misses(self) -> int:
        return sum(self.misses.values())

    def hit_rate(self, bucket: str | None = None) -> float:
        if bucket is None:
            h, m = self.total_hits, self.total_misses
        else:
            h, m = self.hits.get(bucket, 0), self.misses.get(bucket, 0)
        return h / (h + m) if (h + m) else 0.0

    def as_dict(self) -> dict:
        return {
            "total_hits": self.total_hits,
            "total_misses": self.total_misses,
            "total_corrupt": sum(self.corrupt.values()),
            "total_demoted": sum(self.demoted.values()),
            "corrupt": dict(self.corrupt),
            "demoted": dict(self.demoted),
            "per_bucket": {
                b: {"hits": self.hits.get(b, 0), "misses": self.misses.get(b, 0)}
                for b in sorted(set(self.hits) | set(self.misses))
            },
            "per_placement": {
                p: {"hits": self.placement_hits.get(p, 0),
                    "misses": self.placement_misses.get(p, 0)}
                for p in sorted(set(self.placement_hits)
                                | set(self.placement_misses))
            },
        }
