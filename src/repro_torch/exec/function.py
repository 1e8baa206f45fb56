"""``stitch()`` — a jit-like transform executing through the fusion pipeline.

Single-device.  The first call at a new input signature traces ``fn`` to
StitchIR (:func:`repro_torch.core.trace.trace_to_graph`); what follows
depends on the mode:

* ``"stitch"`` — miss-then-upgrade through a
  :class:`repro_torch.cache.CompilationService`: the first call is answered
  at once, by the cached plan on a hit or else by the XLA-style fallback
  plan (``StitchCompiler(mode="xla")``, run eagerly), while a background
  thread runs the whole stitch pipeline (pattern generation, ILP, tuning,
  Triton emission) into the cache; every later call polls the cache and
  upgrades to the stitched plan once it has landed.  A background compile
  that *fails* is surfaced once as a :class:`RuntimeWarning` and in
  :meth:`StitchedFunction.report` — the fallback keeps serving, and the
  doomed compile is not re-kicked.
* ``"shadow"`` — compiles and reports as ``"stitch"`` does, but every call
  runs ``fn`` eagerly.
* ``"offline"`` — compiles synchronously (no background thread) through
  ``service`` (a blocking ``service.compile``, as the reference's offline
  mode does) or else ``compiler`` (a
  :class:`repro_torch.core.StitchCompiler`, cached when it has a
  ``cache``; the default compiler when neither is given); every call at
  that signature runs the compiled plan.
* ``"jit"`` — no stitching: every call runs ``fn`` eagerly.

Tracing is pytree-aware: positional args, kwargs and nested containers
flatten at the boundary and unflatten on return.  A failure to trace or
to compile the first plan raises to the caller: the only route from a
chosen pattern to a fused-torch group is the emitter's static
``StitchInfeasible``, decided at tune time and recorded in the plan's
diagnostics.  A per-call shape drift (without ``respecialize``) serves that
call through the eager function, counted in :meth:`StitchedFunction.report`.
"""

from __future__ import annotations

import copy
import hashlib
import time
import warnings
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch import obs
from repro_torch.device import resolve_device

__all__ = ["StitchedFunction", "stitch", "tree_avals"]

MODES = ("stitch", "shadow", "offline", "jit")


def tree_avals(tree) -> tuple:
    """(shape, dtype) per leaf — the signature every drift check compares."""
    return tuple(
        (tuple(getattr(x, "shape", ())),
         str(getattr(x, "dtype", type(x).__name__)))
        for x in pytree.tree_flatten(tree)[0])


class _Specialization:
    """One traced-and-compiled (graph, artifact) pair at fixed avals."""

    __slots__ = ("status", "graph", "names", "out_names", "out_spec",
                 "compiled", "in_sig", "placement", "trace_seconds", "sig",
                 "lookup_compiler", "error", "warned")

    def __init__(self):
        self.status: str | None = None
        self.graph = None
        self.names: list[str] | None = None
        self.out_names: list[str] | None = None
        self.out_spec = None
        self.compiled = None
        self.in_sig = None
        self.placement = ""
        self.trace_seconds = 0.0
        self.sig = None                  # the graph's cache signature
        self.lookup_compiler = None      # the stitch compiler polls look up
        self.error: str | None = None    # the background compile's failure
        self.warned = False

    @property
    def ok(self) -> bool:
        return self.graph is not None and self.compiled is not None


class StitchedFunction:
    """The callable :func:`stitch` returns — see the module docstring."""

    def __init__(self, fn: Callable, *, mode: str = "stitch", compiler=None,
                 service=None, device=None, static_argnums=(),
                 eligibility_argnums=None, respecialize: int = 0,
                 name: str | None = None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode in ("stitch", "shadow") and compiler is not None:
            raise ValueError(f"mode {mode!r} compiles through service=; "
                             f"compiler= is the offline mode's")
        if mode == "offline" and service is not None and compiler is not None:
            raise ValueError("the offline mode compiles through service= or "
                             "compiler=, not both")
        self.fn = fn
        self.mode = mode
        self.device = resolve_device(device)
        self.name = name or getattr(fn, "__name__", "stitched")
        # hashable args baked into the trace; a new value retraces
        self.static_argnums = tuple(sorted(set(static_argnums)))
        # respecialize=N: a new input signature traces a NEW specialization
        # instead of serving eagerly, LRU-bounded at N (the serving engine's
        # pow2-bucketed prefills: each bucket gets its own plan)
        self.respecialize = int(respecialize)
        # args the per-call drift check covers (None = all); lifetime-fixed
        # operands (the serving engine's params) are excluded to keep the
        # hot-path check cheap
        self.eligibility_argnums = (
            tuple(sorted(set(eligibility_argnums)))
            if eligibility_argnums is not None else None)
        if mode == "offline" and compiler is None and service is None:
            from repro_torch.core import StitchCompiler
            compiler = StitchCompiler()
        if mode in ("stitch", "shadow") and service is None:
            from repro_torch.cache import CompilationService
            service = CompilationService()
        self.compiler = compiler
        self.service = service
        self._specs: dict[Any, _Specialization] = {}
        self._active: _Specialization | None = None
        self.stitched_calls = 0          # served through the compiled artifact
        self.fallback_calls = 0          # shape drift -> eager
        self.jit_calls = 0               # by-design eager ("jit"/"shadow")
        # stitched calls by the mode of the plan that served them: "xla"
        # while a miss serves the fallback plan, "stitch" after the upgrade
        self.plan_calls: dict[str, int] = {}

    # -- argument plumbing -----------------------------------------------------
    def _split(self, args):
        statics = tuple(args[i] for i in self.static_argnums if i < len(args))
        dyn = tuple(a for i, a in enumerate(args)
                    if i not in self.static_argnums)
        return statics, dyn

    def _bind(self, statics):
        if not self.static_argnums:
            return self.fn
        at = dict(zip(self.static_argnums, statics))
        n_static = len(statics)

        def bound(*dyn, **kwargs):
            merged, di = [], iter(dyn)
            for i in range(len(dyn) + n_static):
                merged.append(at[i] if i in at else next(di))
            return self.fn(*merged, **kwargs)

        return bound

    def _in_sig(self, dyn, kwargs):
        if self.eligibility_argnums is not None:
            sel, di = [], 0
            for i in range(len(dyn) + len(self.static_argnums)):
                if i in self.static_argnums:
                    continue
                if i in self.eligibility_argnums:
                    sel.append(dyn[di])
                di += 1
            dyn = tuple(sel)
        return (pytree.tree_structure((dyn, kwargs)), tree_avals((dyn, kwargs)))

    def _spec_key(self, statics, dyn, kwargs):
        if not self.respecialize:
            return statics
        return (statics, self._in_sig(dyn, kwargs))

    def _check_device(self, args, kwargs) -> None:
        for leaf in pytree.tree_flatten((args, kwargs))[0]:
            if isinstance(leaf, torch.Tensor) and leaf.device.type != self.device.type:
                raise ValueError(f"stitch({self.name}): tensor on {leaf.device}, "
                                 f"function bound to {self.device}")

    # -- tracing ---------------------------------------------------------------
    def _trace(self, statics, dyn, kwargs) -> _Specialization:
        from repro_torch.cache.signature import compute_signature
        from repro_torch.core.trace import trace_to_graph

        sp = _Specialization()
        sp.in_sig = self._in_sig(dyn, kwargs)
        if self.respecialize:
            # per-signature placement: each specialization (e.g. each pow2
            # prefill bucket) gets its own cache entry and plan
            digest = hashlib.sha1(repr(sp.in_sig).encode()).hexdigest()[:8]
            sp.placement = f"{self.name}@{digest}"
        bound = self._bind(statics)

        def run_fn(packed):
            return bound(*packed[0], **packed[1])

        t0 = time.perf_counter()
        with obs.span("exec.trace", cat="exec", fn=self.name, mode=self.mode) as tsp:
            sp.graph, sp.names, sp.out_names, sp.out_spec = trace_to_graph(
                run_fn, (dyn, kwargs), name=self.name, return_outputs=True)
            sp.trace_seconds = time.perf_counter() - t0
            if self.mode == "offline" and self.service is not None:
                # the reference's offline mode: a blocking compile through
                # the service (its cache, its stitch compiler)
                sp.compiled = self.service.compile(sp.graph,
                                                   placement=sp.placement)
                sp.status = "compiled"
            elif self.mode == "offline":
                compiler = self.compiler
                if sp.placement and compiler.placement != sp.placement:
                    # the specialization's cache key, as a service's
                    # compile of it would have it
                    compiler = copy.copy(compiler)
                    compiler.placement = sp.placement
                sp.compiled = compiler.compile(sp.graph)
                sp.status = "compiled"
            else:
                sp.sig = compute_signature(sp.graph)
                sp.compiled, sp.status = self.service.compile_or_fallback(
                    sp.graph, placement=sp.placement, device=self.device,
                    sig=sp.sig)
                sp.lookup_compiler = self.service.compiler("stitch",
                                                           sp.placement)
            tsp.set(status=sp.status, placement=sp.placement)
        return sp

    def _get(self, statics, dyn, kwargs) -> _Specialization:
        key = self._spec_key(statics, dyn, kwargs)
        sp = self._specs.get(key)
        if sp is None:
            sp = self._trace(statics, dyn, kwargs)
            self._specs[key] = sp
        elif self.respecialize:
            self._specs[key] = self._specs.pop(key)      # LRU touch
        while self.respecialize and len(self._specs) > self.respecialize:
            evicted = next(iter(self._specs))
            if evicted == key:                           # never evict current
                break
            del self._specs[evicted]
        self._active = sp
        return sp

    # -- miss-then-upgrade polling ---------------------------------------------
    def _poll(self, sp: _Specialization) -> None:
        if sp.status not in ("miss", "pending"):
            return
        svc = self.service
        hit = svc.cache.lookup(sp.graph, sp.lookup_compiler, sig=sp.sig,
                               count=False)
        if hit is not None:
            sp.compiled = hit
            sp.status = "hit"
            # the fallback plan gives way to the stitched one mid-stream
            obs.event("exec.upgrade", cat="exec", fn=self.name,
                      placement=sp.placement,
                      n_kernels=hit.stats.n_kernels,
                      modeled_time_s=hit.stats.modeled_time)
            return
        err = svc.error_for(sp.sig, sp.placement)
        if err is not None:
            # the background stitch compile died: keep serving the fallback
            # plan, stop re-kicking the doomed compile, and say so once
            sp.status = "failed"
            sp.error = err
            if not sp.warned:
                sp.warned = True
                warnings.warn(
                    f"background stitch compile for {self.name!r} failed; "
                    f"serving the fallback plan permanently: {err}",
                    RuntimeWarning, stacklevel=4)
            return
        # re-kick if the background compile was deferred (worker cap): a
        # long-lived function must not serve the fallback forever
        svc.ensure_compiling(sp.graph, sig=sp.sig, placement=sp.placement,
                             device=self.device)

    def poll_upgrade(self) -> None:
        """Poll the active specialization's background upgrade (also done
        automatically on every call)."""
        if self._active is not None and self.service is not None:
            self._poll(self._active)

    # -- execution -------------------------------------------------------------
    def _run(self, sp: _Specialization, dyn, kwargs):
        env = dict(zip(sp.names, pytree.tree_flatten((dyn, kwargs))[0]))
        outs = sp.compiled(env)
        return pytree.tree_unflatten([outs[o] for o in sp.out_names],
                                     sp.out_spec)

    def __call__(self, *args, **kwargs):
        self._check_device(args, kwargs)
        if self.mode == "jit":
            self.jit_calls += 1
            return self.fn(*args, **kwargs)
        statics, dyn = self._split(args)
        sp = self._get(statics, dyn, kwargs)
        if not sp.ok or sp.in_sig != self._in_sig(dyn, kwargs):
            self.fallback_calls += 1
            return self.fn(*args, **kwargs)
        if self.service is not None:
            self._poll(sp)
        if self.mode == "shadow":
            self.jit_calls += 1
            return self.fn(*args, **kwargs)
        with obs.span(f"exec.{self.name}", cat="exec", path="stitched"):
            out = self._run(sp, dyn, kwargs)
        self.stitched_calls += 1
        plan = sp.compiled.stats.mode
        self.plan_calls[plan] = self.plan_calls.get(plan, 0) + 1
        return out

    def warmup(self, *args, **kwargs) -> str | None:
        """Trace and compile (or fetch the fallback) at these example
        arguments without executing; returns the resulting status."""
        if self.mode == "jit":
            return None
        self._check_device(args, kwargs)
        statics, dyn = self._split(args)
        return self._get(statics, dyn, kwargs).status

    def eligible(self, *args, **kwargs) -> bool:
        """True when a call with these arguments would execute through the
        compiled artifact (already traced, signature match)."""
        statics, dyn = self._split(args)
        sp = self._specs.get(self._spec_key(statics, dyn, kwargs))
        return (sp is not None and sp.ok
                and sp.in_sig == self._in_sig(dyn, kwargs))

    def land_plans(self, timeout: float | None = None) -> int:
        """Join background compiles and poll EVERY specialization's upgrade
        (a call polls only the active one) until no compile is in flight;
        returns how many specializations still lack a stitched plan."""
        if self.service is None:
            return 0
        for _ in range(1 + len(self._specs)):
            pending = 0
            for sp in self._specs.values():
                self._poll(sp)
                if sp.status in ("miss", "pending"):
                    pending += 1
            if not pending:
                break
            self.service.wait(timeout)
        return sum(sp.status in ("miss", "pending", "failed")
                   for sp in self._specs.values())

    def wait(self, timeout: float | None = None) -> None:
        """Join in-flight background compiles (tests / orderly shutdown)."""
        if self.service is not None:
            self.service.wait(timeout)

    # -- introspection ---------------------------------------------------------
    @property
    def ok(self) -> bool:
        return self._active is not None and self._active.ok

    @property
    def status(self) -> str | None:
        return self._active.status if self._active is not None else None

    @property
    def graph(self):
        return self._active.graph if self._active is not None else None

    @property
    def compiled(self):
        return self._active.compiled if self._active is not None else None

    @property
    def placement(self) -> str:
        return self._active.placement if self._active is not None else ""

    def plan_stats(self) -> dict | None:
        if self._active is None or self._active.compiled is None:
            return None
        return self._plan_stats(self._active)

    @staticmethod
    def _plan_stats(sp: _Specialization) -> dict | None:
        if sp.compiled is None:
            return None
        s = sp.compiled.stats
        return {"mode": s.mode, "n_kernels": s.n_kernels, "n_ops": s.n_ops,
                "triton_groups": s.triton_groups,
                "torch_groups": s.torch_groups,
                "op_groups": s.n_kernels - s.triton_groups - s.torch_groups,
                "packs": s.packs, "packed_subgraphs": s.packed_subgraphs,
                "modeled_time": s.modeled_time,
                "cache_status": s.cache_status,
                "compile_seconds": s.compile_seconds,
                "trace_seconds": sp.trace_seconds,
                "stage_seconds": dict(s.stage_seconds),
                "ilp_method": s.ilp.method if s.ilp is not None else None,
                "verify": s.verify}

    def report(self) -> dict:
        """Call routing, plan + kernel stats, cache hit rates and every
        background-compile failure — one dict with the reference's report
        keys (a trace or first-compile failure raises instead)."""
        sp = self._active
        out = {
            "schema": obs.EXEC_REPORT_SCHEMA,
            "name": self.name,
            "status": self.status,
            "mode": self.mode,
            "calls": {"stitched": self.stitched_calls,
                      "fallback": self.fallback_calls,
                      "jit": self.jit_calls},
            "stitched_calls": self.stitched_calls,
            "fallback_calls": self.fallback_calls,
            "jit_calls": self.jit_calls,
            "plan_calls": dict(self.plan_calls),
            "specializations": len(self._specs),
            "specialization_cap": self.respecialize or None,
            "placement": sp.placement if sp is not None else "",
            "plan": self.plan_stats(),
            "plans": {s.placement or self.name: {"status": s.status,
                                                 "plan": self._plan_stats(s)}
                      for s in self._specs.values()},
            "error": sp.error if sp is not None else None,
            "errors": {},
            # structured StitchInfeasible records from tuning: why chosen
            # patterns run as fused-torch groups
            "diagnostics": (list(sp.compiled.stats.diagnostics)
                            if sp is not None and sp.compiled is not None
                            else []),
            "cache": None,
            "service_error": None,
            "measured": None,
        }
        if self.service is not None:
            out["cache"] = self.service.cache.report()
            out["service_error"] = self.service.last_error
            out["errors"] = self.service.error_report()
        return out


def stitch(fn: Callable, *, mode: str = "stitch", compiler=None,
           service=None, device=None, static_argnums=(),
           eligibility_argnums=None, respecialize: int = 0,
           name: str | None = None) -> StitchedFunction:
    """Wrap ``fn`` for execution through the FusionStitching pipeline.

    Args:
      fn: a PyTorch function of pytree args/kwargs returning a pytree of
        tensors.
      mode: ``"stitch"`` (the default, as the reference's:
        miss-then-upgrade, the fallback plan at once, the stitched plan once
        its background compile lands), ``"shadow"`` (compile + report,
        serve eagerly), ``"offline"`` (blocking compile at the first call
        per signature) or ``"jit"`` (eager, no stitching).
      compiler: the offline mode's :class:`repro_torch.core.StitchCompiler`
        when no ``service`` is given (default: H100 hardware model, default
        ``GenConfig``); with a ``cache`` its compiles replay and insert
        cached plans.  The stitch and shadow modes refuse it.
      service: a :class:`repro_torch.cache.CompilationService`: the stitch
        and shadow modes compile through it in the background (a default,
        in-memory cache, is created when omitted); the offline mode, when
        given one, compiles through it, blocking.
      device: where the function runs — ``"cuda"`` by default (raises when
        there is no card), ``"cpu"`` on request.
      static_argnums: hashable args baked into the trace; a new value
        retraces into a new specialization.
      eligibility_argnums: restrict the per-call shape-drift check to these
        args (default all).
      respecialize: N > 0 makes a drifted input signature trace a NEW
        specialization instead of running eagerly, LRU-bounded at N.
      name: graph name for reports.
    """
    return StitchedFunction(
        fn, mode=mode, compiler=compiler, service=service, device=device,
        static_argnums=static_argnums, eligibility_argnums=eligibility_argnums,
        respecialize=respecialize, name=name)
