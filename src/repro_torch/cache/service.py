"""StitchCache facade + compilation service (miss-then-upgrade).

:class:`StitchCache` binds the three lower pieces together — signatures
(:mod:`.signature`), bucketing/eviction (:mod:`.policy`), and the two-tier
store (:mod:`.store`) — behind two operations:

* ``lookup(g, compiler)``  — signature the graph, probe the store, and on a
  hit *replay* the record: rebuild executable groups on the new graph
  (canonical indices -> this graph's node names), re-instantiating the
  generated Triton kernels from the recorded ``(row_block, scratch)``
  choice.  The expensive head of compilation — pattern generation, ILP
  solving, template enumeration — is skipped entirely.
* ``insert(g, compiled)``  — extract a :class:`PlanRecord` in canonical
  coordinates from a freshly compiled graph and write it through both tiers.

:class:`CompilationService` is the serving-path wrapper: ``compile_or_
fallback`` answers *immediately* — with the replayed stitched executable on
a hit, or with a cheap XLA-style executable (``StitchCompiler(mode="xla")``,
run eagerly) on a miss — while a background thread runs the full stitch
pipeline and populates the cache, so the *next* request for the same
(graph, bucket) upgrades to the stitched plan.  Tail latency never pays the
planner's cost.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time

import torch

from repro_torch import obs
from repro_torch.core.compiler import CompiledGraph, FusionStats, StitchCompiler, _Group
from repro_torch.core.cost import H100, HardwareModel
from repro_torch.core.ir import Graph
from repro_torch.core.pattern import FusionPattern, PackPattern
from repro_torch.core.tuner import grid_row_block

from .policy import BucketPolicy, BucketStats, EvictionPolicy
from .signature import GraphSignature, compute_signature, config_key
from .store import DiskStore, GroupRecord, MemoryStore, PlanRecord, TwoTierStore

__all__ = ["StitchCache", "CompilationService", "extract_record", "replay_record"]


def extract_record(
    g: Graph,
    sig: GraphSignature,
    compiled: CompiledGraph,
    bucket_key: str,
    hw: str,
    solve_seconds: float = 0.0,
    placement: str = "",
    config: str = "",
) -> PlanRecord:
    """Freeze a compiled plan into canonical coordinates."""
    idx = sig.node_to_index
    groups = []
    for grp in compiled.groups:
        row_block = None
        scratch: tuple[int, ...] = ()
        if grp.tuned is not None:
            row_block = grid_row_block(grp.tuned.template)
            scratch = tuple(sorted(idx[n] for n in grp.tuned.template.scratch_ops))
        pack: tuple[tuple[int, ...], ...] = ()
        if grp.pack:
            pack = tuple(sorted(
                tuple(sorted(idx[m] for m in gset)) for gset in grp.pack
            ))
        groups.append(
            GroupRecord(
                members=tuple(sorted(idx[m] for m in grp.members)),
                kind=grp.kind,
                row_block=row_block,
                scratch=scratch,
                pack=pack,
            )
        )
    ilp = compiled.stats.ilp
    return PlanRecord(
        graph_key=sig.graph_key,
        bucket_key=bucket_key,
        shape_key=sig.shape_key,
        mode=compiled.stats.mode,
        hw=hw,
        n_nodes=len(sig.canon_order),
        groups=tuple(groups),
        objective=ilp.objective if ilp else 0.0,
        ilp_iterations=ilp.iterations if ilp else 0,
        solve_seconds=solve_seconds,
        placement=placement,
        config=config,
    )


def replay_record(
    g: Graph, sig: GraphSignature, rec: PlanRecord, compiler: StitchCompiler
) -> CompiledGraph | None:
    """Rebuild an executable from a record, skipping search/solve/tune.

    Returns None when the record cannot apply (node-count mismatch from a
    hash collision) — the caller falls back to a cold compile.  Each group
    keeps its recorded kind: a ``triton`` group that fails to
    re-instantiate at this graph's concrete shapes (a bucketed hit at a new
    length outside the kernel's feasible blocks) degrades to a fused-torch
    group; numerics are unaffected.
    """
    if rec.n_nodes != len(sig.canon_order):
        return None
    names = sig.canon_order
    n = len(names)
    for gr in rec.groups:          # corrupt/hand-edited records: treat as miss
        flat_pack = tuple(i for gset in gr.pack for i in gset)
        if any(not 0 <= i < n for i in gr.members + gr.scratch + flat_pack):
            return None
    stats = FusionStats(
        mode=compiler.mode,
        n_ops=len(g.compute_nodes()),
        n_kernels=0,
        cache_status="hit",
    )
    groups: list[_Group] = []
    covered: set[str] = set()
    diag_start = len(compiler.tuner.diagnostics)
    for gr in rec.groups:
        members = frozenset(names[i] for i in gr.members)
        covered |= members
        if gr.kind == "op":
            groups.append(_Group(members, "op"))
            continue
        pack = tuple(frozenset(names[i] for i in gset) for gset in gr.pack) or None
        if pack:
            try:
                p: FusionPattern = PackPattern(g, members, "cache",
                                               member_groups=pack)
            except ValueError:
                return None        # malformed pack provenance: treat as miss
            stats.packs += 1
            stats.packed_subgraphs += len(pack)
        else:
            p = FusionPattern(g, members, "cache")
        stats.pattern_classes[p.pattern_class] = (
            stats.pattern_classes.get(p.pattern_class, 0) + 1
        )
        tuned = None
        if gr.kind == "triton" and compiler.mode == "stitch":
            tuned = compiler.tuner.instantiate(
                p,
                row_block=gr.row_block,
                scratch_names=[names[i] for i in gr.scratch],
            )
        if tuned is not None:
            groups.append(_Group(members, "triton", tuned, pack))
            stats.triton_groups += 1
            stats.scratch_requested += sum(compiler.cost.scratch_request(p).values())
            stats.scratch_allocated += tuned.scratch_plan.allocated
            if tuned.scratch_plan.allocated:
                stats.patterns_with_scratch += 1
        else:
            groups.append(_Group(members, "torch", None, pack))
            stats.torch_groups += 1
    # a record always covers every compute node of an isomorphic graph, but
    # degrade gracefully if it somehow doesn't
    for node in g.compute_nodes():
        if node.name not in covered:
            groups.append(_Group(frozenset([node.name]), "op"))
    stats.n_kernels = len(groups)
    stats.diagnostics = list(compiler.tuner.diagnostics[diag_start:])
    stats.modeled_time = compiler.modeled_time(g, [grp.members for grp in groups])
    return CompiledGraph(g, groups, stats)


class StitchCache:
    """Thread-safe two-tier fusion-plan cache with shape bucketing."""

    def __init__(
        self,
        directory: str | None = None,
        bucket_policy: BucketPolicy | None = None,
        eviction: EvictionPolicy | None = None,
    ):
        eviction = eviction or EvictionPolicy()
        self.bucket_policy = bucket_policy or BucketPolicy()
        disk = (
            DiskStore(directory, max_entries=eviction.disk_entries,
                      on_corrupt=self._note_corrupt)
            if directory is not None
            else None
        )
        self.store = TwoTierStore(MemoryStore(eviction.memory_entries), disk)
        self.stats = BucketStats()
        self._lock = threading.RLock()
        # keys whose replayed record failed static verification (warn once)
        self._verify_warned: set[tuple] = set()
        # Live-artifact memo: (id(graph), mode, hw, placement, config) ->
        # (graph, artifact, bucket, node count at memo time).  Replay on a
        # record rebuilds the Triton callables (cheap but not free);
        # recompiling the *same* unmutated Graph object can skip even that.
        # The value holds a strong ref to the graph so the id key cannot be
        # recycled.
        self._live: "dict[tuple, tuple[Graph, CompiledGraph, str, int]]" = {}
        self._live_capacity = eviction.memory_entries

    # -- keys -----------------------------------------------------------------
    def key_for(self, sig: GraphSignature, mode: str = "stitch",
                hw: str = "", placement: str = "", config: str = "") -> tuple:
        # hw is part of the durable key: a plan tuned for one card's launch
        # latency / on-chip budget must not shadow another card's optimum.
        # placement (the specialization key) is too, and config is the
        # GenConfig digest (signature.config_key): different
        # pattern-generation knobs legitimately produce different plans.
        return (sig.graph_key, sig.bucket_key(self.bucket_policy), mode, hw,
                placement, config)

    def signature_of(self, g: Graph) -> GraphSignature:
        return compute_signature(g)

    @staticmethod
    def _live_key(g: Graph, compiler) -> tuple:
        return (id(g), compiler.mode, compiler.hw.name, compiler.placement,
                config_key(compiler.gen_cfg))

    # -- operations -----------------------------------------------------------
    def lookup(
        self,
        g: Graph,
        compiler: StitchCompiler,
        sig: GraphSignature | None = None,
        count: bool = True,
    ) -> CompiledGraph | None:
        placement = compiler.placement
        with self._lock:
            live = self._live.get(self._live_key(g, compiler))
        if live is not None and live[0] is g and live[3] == len(g.nodes):
            if count:
                with self._lock:
                    self.stats.record(live[2], hit=True, placement=placement)
            art = copy.copy(live[1])   # fresh stats: don't rewrite the miss's
            art.stats = dataclasses.replace(live[1].stats, cache_status="hit")
            return art
        sig = sig or compute_signature(g)
        key = self.key_for(sig, compiler.mode, compiler.hw.name, placement,
                           config_key(compiler.gen_cfg))
        with self._lock:
            rec = self.store.get(key)
        if rec is not None and compiler.verify != "off":
            # static plan verification against the *live* graph: a stale,
            # corrupt, or hand-edited record is demoted to a miss here —
            # never instantiated — and the recompile overwrites it
            rec = self._verified(g, sig, rec, compiler, key)
        compiled = None
        if rec is not None:
            try:
                compiled = replay_record(g, sig, rec, compiler)
            except Exception:              # noqa: BLE001 — an unreplayable
                compiled = None            # record is a miss
            if compiled is not None:
                self._remember_live(g, compiled, compiler, key[1])
        if count:
            with self._lock:
                self.stats.record(key[1], hit=compiled is not None,
                                  placement=placement)
        return compiled

    def _note_corrupt(self, key: tuple) -> None:
        """DiskStore callback: count an unreadable record in bucket stats."""
        with self._lock:
            self.stats.record_corrupt(key[1])

    def _verified(self, g: Graph, sig: GraphSignature, rec: PlanRecord,
                  compiler, key: tuple) -> PlanRecord | None:
        from repro_torch.analysis import errors, format_findings, verify_record

        budget = compiler.gen_cfg.scratch_budget
        if budget is None:
            budget = compiler.hw.onchip_budget
        findings = verify_record(g, sig.canon_order, rec,
                                 scratch_budget=budget, cost=compiler.cost,
                                 reg_budget=compiler.cost.reg_budget)
        bad = errors(findings)
        if not bad:
            return rec
        with self._lock:
            self.stats.record_demoted(key[1])
            warn = key not in self._verify_warned
            self._verify_warned.add(key)
        if warn:
            import warnings

            warnings.warn(
                f"cached plan for graph {g.name!r} (bucket {key[1][:12]}) "
                f"failed static verification and was demoted to a miss:\n"
                f"{format_findings(bad, limit=5)}",
                RuntimeWarning, stacklevel=4)
        obs.event("cache.verify_demote", cat="cache", graph=g.name,
                  bucket=key[1], codes=sorted({f.code for f in bad}))
        return None

    def _remember_live(self, g: Graph, compiled: CompiledGraph, compiler,
                       bucket: str) -> None:
        with self._lock:
            if len(self._live) >= self._live_capacity:
                self._live.clear()
            self._live[self._live_key(g, compiler)] = (
                g, compiled, bucket, len(g.nodes))

    def insert(
        self,
        g: Graph,
        compiled: CompiledGraph,
        sig: GraphSignature | None = None,
        solve_seconds: float = 0.0,
        compiler: StitchCompiler | None = None,
    ) -> PlanRecord:
        sig = sig or compute_signature(g)
        bucket = sig.bucket_key(self.bucket_policy)
        hw = compiler.hw.name if compiler is not None else ""
        placement = compiler.placement if compiler is not None else ""
        cfg_key = config_key(compiler.gen_cfg if compiler is not None else None)
        rec = extract_record(g, sig, compiled, bucket, hw, solve_seconds,
                             placement=placement, config=cfg_key)
        # the live artifact first: a poller that finds the record finds the
        # artifact itself, never a replay of it
        if compiler is not None:
            self._remember_live(g, compiled, compiler, bucket)
        with self._lock:
            self.store.put(rec)
        return rec

    def report(self) -> dict:
        with self._lock:
            out = self.stats.as_dict()
            out["memory_entries"] = len(self.store.memory)
            out["memory_evictions"] = self.store.memory.evictions
            out["disk_put_errors"] = self.store.disk_put_errors
            if self.store.disk is not None:
                out["disk_entries"] = len(self.store.disk)
                out["disk_corrupt_reads"] = self.store.disk.corrupt_reads
        return out


def _on(device):
    """The background thread's device: CUDA calls made while it compiles
    (the kernels it loads) go to the function's card, not the default."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class CompilationService:
    """Warm-start compilation frontend for the serving tier: a miss is
    answered by the ``xla`` plan at once while the stitch plan compiles in
    the background."""

    # background compiles in flight at most: a cold-start burst does not
    # stack ILP and tuning pipelines (an instance may set its own; 0 defers
    # every compile to a later call)
    max_background = 2

    def __init__(
        self,
        cache: StitchCache | None = None,
        hw: HardwareModel = H100,
        gen_cfg=None,
        plan_budget: float | None = None,
    ):
        self.cache = cache or StitchCache()
        self.hw = hw
        self.gen_cfg = gen_cfg
        # wall-clock budget (seconds) for the fusion-plan ILP of every
        # compile this service spawns — see core.ilp's anytime mode; None
        # means solve to optimality
        self.plan_budget = plan_budget
        self._lock = threading.Lock()
        self._pending: set[tuple] = set()
        self._threads: list[threading.Thread] = []
        self.last_error: str | None = None   # last background-compile failure
        self.errors: dict[tuple, str] = {}   # per-key background failures

    def compiler(self, mode: str, placement: str = "") -> StitchCompiler:
        return StitchCompiler(
            hw=self.hw,
            mode=mode,
            gen_cfg=self.gen_cfg,
            cache=self.cache if mode == "stitch" else None,
            placement=placement,
            plan_budget=self.plan_budget,
        )

    def _key(self, sig: GraphSignature, placement: str) -> tuple:
        return self.cache.key_for(sig, "stitch", self.hw.name, placement,
                                  config_key(self.gen_cfg))

    def error_for(self, sig: GraphSignature, placement: str = "") -> str | None:
        """The recorded background-compile failure for this graph's stitch
        key, or None.  Callers poll it so a doomed compile is surfaced
        (warn-once + report) instead of silently serving the fallback."""
        with self._lock:
            return self.errors.get(self._key(sig, placement))

    def error_report(self) -> dict[str, str]:
        """Every recorded background failure, keyed by a stable readable
        string (``graph_key/bucket/mode/hw/placement/config``) — what
        ``StitchedFunction.report()['errors']`` exposes."""
        with self._lock:
            return {"/".join(str(p) for p in key): msg
                    for key, msg in self.errors.items()}

    def pending(self) -> int:
        """Background compiles in flight."""
        with self._lock:
            return len(self._pending)

    def compile(self, g: Graph, placement: str = "") -> CompiledGraph:
        """Blocking cache-aware full compile (offline / warmup path)."""
        return self.compiler("stitch", placement).compile(g)

    def compile_or_fallback(self, g: Graph, placement: str = "", device=None,
                            sig: GraphSignature | None = None
                            ) -> tuple[CompiledGraph, str]:
        """Never blocks on the stitch pipeline.

        Returns ``(executable, status)`` where status is ``"hit"`` (replayed
        stitched plan), ``"pending"`` (a background compile for this key is
        already in flight, or the worker cap deferred it), or ``"miss"``
        (fallback returned now, upgrade kicked off in the background).

        ``placement`` (the specialization key) scopes both the lookup and
        the background compile's insert; ``device`` is where the graph runs,
        the background thread's device; ``sig`` the graph's signature when
        the caller already has it.
        """
        t0 = time.perf_counter()
        stitch = self.compiler("stitch", placement)
        sig = sig or compute_signature(g)
        hit = self.cache.lookup(g, stitch, sig=sig)
        # one hit-or-miss event per compiled graph: timeline evidence of
        # which requests replayed a plan and which served the fallback
        obs.event("cache.hit" if hit is not None else "cache.miss",
                  cat="cache", graph=g.name, placement=placement,
                  bucket=sig.bucket_key(self.cache.bucket_policy))
        if hit is not None:
            hit.stats.compile_seconds = time.perf_counter() - t0
            return hit, "hit"
        fallback = self.compiler("xla").compile(g)
        spawned = self.ensure_compiling(g, sig=sig, placement=placement,
                                        device=device)
        return fallback, "miss" if spawned else "pending"

    def ensure_compiling(self, g: Graph, sig: GraphSignature | None = None,
                         placement: str = "", device=None) -> bool:
        """Kick the background stitch compile for ``g`` unless one is already
        in flight for its key.  Returns True when a new compile was spawned.
        A request deferred by the worker cap (cold-start burst) is re-kicked
        by calling this again; a key whose compile *failed* is never retried
        — the failure is recorded in ``errors`` and callers surface it via
        :meth:`error_for`.  On a card the thread loads the landed plan's
        generated kernels (:meth:`StitchedKernel.load`) before it ends."""
        sig = sig or compute_signature(g)
        key = self._key(sig, placement)
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            if key in self._pending:
                return False
            if key in self.errors:
                # this key's compile already failed: re-running it would fail
                # the same way forever — callers surface it via error_for()
                return False
            if len(self._threads) >= self.max_background:
                # bounded worker count: don't stack N ILP+tuning pipelines on
                # a cold-start burst; this key retries on a later call
                return False
            self._pending.add(key)
        stitch = self.compiler("stitch", placement)
        obs.event("compile.start", cat="compile", graph=g.name,
                  placement=placement, background=True)

        def _upgrade():
            try:
                with obs.span("compile.background", cat="compile",
                              graph=g.name, placement=placement), _on(device):
                    compiled = stitch.compile(g, bypass_cache_lookup=True)
                    if device is not None and torch.device(device).type == "cuda":
                        for grp in compiled.groups:
                            load = getattr(grp.tuned and grp.tuned.callable,
                                           "load", None)
                            if load is not None:
                                load()
            except Exception as e:          # noqa: BLE001 — surfaced via
                with self._lock:            # last_error / report
                    self.last_error = f"{type(e).__name__}: {e}"
                    self.errors[key] = self.last_error
                obs.event("compile.fail", cat="compile", graph=g.name,
                          placement=placement, error=self.last_error)
            finally:
                with self._lock:
                    self._pending.discard(key)

        t = threading.Thread(target=_upgrade, daemon=True, name="stitch-upgrade")
        with self._lock:
            self._threads.append(t)
        t.start()
        return True

    def wait(self, timeout: float | None = None) -> None:
        """Join in-flight background compiles (tests / orderly shutdown)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(
                None if deadline is None else max(0.0, deadline - time.monotonic())
            )
