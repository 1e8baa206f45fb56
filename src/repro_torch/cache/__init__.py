"""StitchCache — persistent fusion-plan cache with shape bucketing.

The optimize-once/run-many amortization layer: canonical graph signatures
(:mod:`.signature`), pad-to-bucket shape rules + LRU eviction
(:mod:`.policy`), a two-tier memory+disk store (:mod:`.store`), and the
cache facade / miss-then-upgrade compilation service (:mod:`.service`).
"""

from .policy import BucketPolicy, BucketStats, EvictionPolicy
from .service import CompilationService, StitchCache, extract_record, replay_record
from .signature import (GraphSignature, compute_signature, config_key,
                        node_struct_hashes, placement_key)
from .store import DiskStore, GroupRecord, MemoryStore, PlanRecord, TwoTierStore

__all__ = [
    "BucketPolicy", "BucketStats", "EvictionPolicy",
    "GraphSignature", "compute_signature", "config_key", "node_struct_hashes",
    "placement_key",
    "DiskStore", "GroupRecord", "MemoryStore", "PlanRecord", "TwoTierStore",
    "CompilationService", "StitchCache", "extract_record", "replay_record",
]
