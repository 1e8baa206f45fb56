"""Two-tier plan store: in-memory LRU over an on-disk JSON layer.

A :class:`PlanRecord` is the durable form of a solved fusion plan — the
output of pattern generation + ILP + tuning, in *canonical coordinates*
(node indices from :mod:`repro_torch.cache.signature`, never names), so it
replays onto any graph with the same ``graph_key`` regardless of how that
graph was traced.  Records deliberately contain no callables or tensors: the
generated Triton kernels are re-instantiated from ``(members, row_block,
scratch)`` on replay, which is the cheap tail of compilation (the expensive
head — search and solving — is what the record lets us skip).

Disk layout::

    <dir>/plan_<graph12>_<bucket12>_<mode>_<hw>[_<placement>][_<config12>].json
    written under a temporary name then os.replace()d — a torn write is
    never visible, and two writers of one key each replace it whole.
"""

from __future__ import annotations

import json
import os
import threading
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["GroupRecord", "PlanRecord", "MemoryStore", "DiskStore", "TwoTierStore"]

# The reference's v4 layout (placement, GenConfig digest and pack provenance
# in every record) with the port's group kinds; other versions read as
# misses.  A record of the reference's kinds ("pallas"/"jnp") fails replay
# verification and is a miss too.
RECORD_VERSION = 4


@dataclass(frozen=True)
class GroupRecord:
    """One kernel of the plan, in canonical node indices."""

    members: tuple[int, ...]
    kind: str                           # "triton" | "torch" | "op"
    row_block: int | None = None        # triton groups: tuned GRID factor
    scratch: tuple[int, ...] = ()       # triton groups: scratch-marked members
    # horizontal packs: the independent member subgraphs (canonical indices);
    # () for ordinary dependence-connected groups
    pack: tuple[tuple[int, ...], ...] = ()

    def to_json(self) -> dict:
        d = {
            "members": sorted(self.members),
            "kind": self.kind,
            "row_block": self.row_block,
            "scratch": sorted(self.scratch),
        }
        if self.pack:
            d["pack"] = sorted(sorted(gset) for gset in self.pack)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "GroupRecord":
        return cls(
            members=tuple(d["members"]),
            kind=d["kind"],
            row_block=d.get("row_block"),
            scratch=tuple(d.get("scratch", ())),
            pack=tuple(tuple(gset) for gset in d.get("pack", ())),
        )


@dataclass(frozen=True)
class PlanRecord:
    graph_key: str
    bucket_key: str
    shape_key: str                      # exact shapes the plan was solved at
    mode: str
    hw: str                             # hardware the plan was tuned for
    n_nodes: int                        # canonical-order length (replay check)
    groups: tuple[GroupRecord, ...]
    objective: float = 0.0              # ILP objective (observability)
    ilp_iterations: int = 0
    solve_seconds: float = 0.0          # cold compile wall time
    placement: str = ""                 # specialization key ("" = plain compile)
    config: str = ""                    # GenConfig digest (signature.config_key)

    @property
    def key(self) -> tuple[str, str, str, str, str, str]:
        return (self.graph_key, self.bucket_key, self.mode, self.hw,
                self.placement, self.config)

    def to_json(self) -> dict:
        return {
            "v": RECORD_VERSION,
            "graph_key": self.graph_key,
            "bucket_key": self.bucket_key,
            "shape_key": self.shape_key,
            "mode": self.mode,
            "hw": self.hw,
            "placement": self.placement,
            "config": self.config,
            "n_nodes": self.n_nodes,
            "groups": [g.to_json() for g in self.groups],
            "objective": self.objective,
            "ilp_iterations": self.ilp_iterations,
            "solve_seconds": self.solve_seconds,
        }

    @classmethod
    def from_json(cls, d: dict) -> "PlanRecord | None":
        if d.get("v") != RECORD_VERSION:
            return None                  # stale format: treat as miss
        return cls(
            graph_key=d["graph_key"],
            bucket_key=d["bucket_key"],
            shape_key=d["shape_key"],
            mode=d["mode"],
            hw=d["hw"],
            n_nodes=d["n_nodes"],
            groups=tuple(GroupRecord.from_json(g) for g in d["groups"]),
            objective=d.get("objective", 0.0),
            ilp_iterations=d.get("ilp_iterations", 0),
            solve_seconds=d.get("solve_seconds", 0.0),
            placement=d.get("placement", ""),
            config=d.get("config", ""),
        )


class MemoryStore:
    """Bounded LRU of PlanRecords."""

    def __init__(self, capacity: int = 128):
        self.capacity = capacity
        self._d: "OrderedDict[tuple, PlanRecord]" = OrderedDict()
        self.evictions = 0

    def get(self, key: tuple) -> PlanRecord | None:
        rec = self._d.get(key)
        if rec is not None:
            self._d.move_to_end(key)
        return rec

    def put(self, rec: PlanRecord) -> None:
        self._d[rec.key] = rec
        self._d.move_to_end(rec.key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._d)


class DiskStore:
    """One atomic JSON file per entry; survives process restarts.

    A truncated/corrupt/garbage record file reads as a *miss*: the first
    encounter per file emits one ``RuntimeWarning`` (and calls
    ``on_corrupt(key)`` so the owner can count it in its bucket stats);
    it never propagates an exception into the compile path — the plan
    simply recompiles and the next ``put`` overwrites the bad file.
    """

    def __init__(self, directory: str | os.PathLike, max_entries: int | None = None,
                 on_corrupt=None):
        self.directory = Path(directory)
        self.max_entries = max_entries
        self.on_corrupt = on_corrupt
        self.corrupt_reads = 0
        self._warned_corrupt: set[str] = set()

    def _path(self, key: tuple) -> Path:
        graph_key, bucket_key, mode, hw, placement, config = key
        hw_slug = "".join(c if c.isalnum() else "-" for c in hw)
        # placement slug keeps the specialization human-greppable; the full
        # string is re-checked against the record body (rec.key != key below)
        pl_slug = "".join(c for c in placement if c.isalnum())[:24]
        pl_part = f"_{pl_slug}" if pl_slug else ""
        cfg_part = f"_{config[:12]}" if config else ""
        return (self.directory
                / f"plan_{graph_key[:12]}_{bucket_key[:12]}_{mode}_{hw_slug}"
                  f"{pl_part}{cfg_part}.json")

    def get(self, key: tuple) -> PlanRecord | None:
        path = self._path(key)
        if not path.exists():
            return None
        try:
            with open(path) as f:
                rec = PlanRecord.from_json(json.load(f))
        except OSError:
            return None                  # transient read failure == miss
        except Exception as err:         # truncated JSON, wrong-typed body,
            self._note_corrupt(path, key, err)   # missing fields, ...
            return None
        if rec is not None and rec.key != key:
            return None                  # 12-hex-char filename collision
        return rec

    def _note_corrupt(self, path: Path, key: tuple, err: Exception) -> None:
        self.corrupt_reads += 1
        if self.on_corrupt is not None:
            self.on_corrupt(key)
        sp = str(path)
        if sp not in self._warned_corrupt:
            self._warned_corrupt.add(sp)
            warnings.warn(
                f"discarding corrupt plan record {path} "
                f"({type(err).__name__}: {err}); treating as a cache miss",
                RuntimeWarning, stacklevel=4)

    def put(self, rec: PlanRecord) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        path = self._path(rec.key)
        # one temporary name per writer: two threads or processes that land
        # the same key never write into each other's file
        tmp = path.with_suffix(
            f".json.{os.getpid()}.{threading.get_ident()}.tmp")
        with open(tmp, "w") as f:
            json.dump(rec.to_json(), f)
        os.replace(tmp, path)
        if self.max_entries is not None:
            entries = sorted(
                self.directory.glob("plan_*.json"), key=lambda p: p.stat().st_mtime
            )
            for stale in entries[: max(0, len(entries) - self.max_entries)]:
                stale.unlink(missing_ok=True)

    def __len__(self) -> int:
        if not self.directory.exists():
            return 0
        return sum(1 for _ in self.directory.glob("plan_*.json"))


class TwoTierStore:
    """Memory LRU in front of (optional) disk persistence.

    Disk hits are promoted into memory; memory inserts are written through
    to disk so a restarted process warm-starts from the same plans.
    """

    def __init__(self, memory: MemoryStore, disk: DiskStore | None = None):
        self.memory = memory
        self.disk = disk
        self.disk_put_errors = 0

    def get(self, key: tuple) -> PlanRecord | None:
        rec = self.memory.get(key)
        if rec is not None:
            return rec
        if self.disk is not None:
            rec = self.disk.get(key)
            if rec is not None:
                self.memory.put(rec)     # promote
        return rec

    def put(self, rec: PlanRecord) -> None:
        self.memory.put(rec)
        if self.disk is not None:
            try:
                self.disk.put(rec)
            except OSError:
                # a full/read-only disk must not discard a finished compile;
                # the memory tier still serves this process
                self.disk_put_errors += 1
