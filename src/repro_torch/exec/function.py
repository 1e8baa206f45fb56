"""``stitch()`` — a jit-like transform executing through the fusion pipeline.

Single-device.  Two modes:

* ``"offline"`` — the first call at a new input signature traces ``fn`` to
  StitchIR (:func:`repro_torch.core.trace.trace_to_graph`) and compiles it
  synchronously (pattern generation, ILP, tuning, Triton emission); every
  call at that signature then runs the compiled artifact.
* ``"jit"`` — no stitching: every call runs ``fn`` eagerly.

Tracing is pytree-aware: positional args, kwargs and nested containers
flatten at the boundary and unflatten on return.  A failure to trace or
compile raises to the caller: the only route from a chosen pattern to a
fused-torch group is the emitter's static ``StitchInfeasible``, decided at
tune time and recorded in the plan's diagnostics.  A per-call shape drift
(without ``respecialize``) serves that call through the eager function,
counted in :meth:`StitchedFunction.report`.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch import obs
from repro_torch.device import resolve_device

__all__ = ["StitchedFunction", "stitch", "tree_avals"]

MODES = ("offline", "jit")


def tree_avals(tree) -> tuple:
    """(shape, dtype) per leaf — the signature every drift check compares."""
    return tuple(
        (tuple(getattr(x, "shape", ())),
         str(getattr(x, "dtype", type(x).__name__)))
        for x in pytree.tree_flatten(tree)[0])


class _Specialization:
    """One traced-and-compiled (graph, artifact) pair at fixed avals."""

    __slots__ = ("status", "graph", "names", "out_names", "out_spec",
                 "compiled", "in_sig", "placement", "trace_seconds")

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

    @property
    def ok(self) -> bool:
        return self.graph is not None and self.compiled is not None


class StitchedFunction:
    """The callable :func:`stitch` returns — see the module docstring."""

    def __init__(self, fn: Callable, *, mode: str = "offline", compiler=None,
                 device=None, eligibility_argnums=None,
                 respecialize: int = 0, name: str | None = None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.fn = fn
        self.mode = mode
        self.device = resolve_device(device)
        self.name = name or getattr(fn, "__name__", "stitched")
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
        if mode != "jit" and compiler is None:
            from repro_torch.core import StitchCompiler
            compiler = StitchCompiler()
        self.compiler = compiler
        self._specs: dict[Any, _Specialization] = {}
        self._active: _Specialization | None = None
        self.stitched_calls = 0          # served through the compiled artifact
        self.fallback_calls = 0          # shape drift -> eager
        self.jit_calls = 0               # by-design eager ("jit" mode)

    # -- argument plumbing -----------------------------------------------------
    def _in_sig(self, args, kwargs):
        if self.eligibility_argnums is not None:
            args = tuple(a for i, a in enumerate(args)
                         if i in self.eligibility_argnums)
        return (pytree.tree_structure((args, kwargs)), tree_avals((args, kwargs)))

    def _check_device(self, args, kwargs) -> None:
        for leaf in pytree.tree_flatten((args, kwargs))[0]:
            if isinstance(leaf, torch.Tensor) and leaf.device.type != self.device.type:
                raise ValueError(f"stitch({self.name}): tensor on {leaf.device}, "
                                 f"function bound to {self.device}")

    # -- tracing ---------------------------------------------------------------
    def _trace(self, args, kwargs) -> _Specialization:
        from repro_torch.core.trace import trace_to_graph

        sp = _Specialization()
        sp.in_sig = self._in_sig(args, kwargs)
        if self.respecialize:
            digest = hashlib.sha1(repr(sp.in_sig).encode()).hexdigest()[:8]
            sp.placement = f"{self.name}@{digest}"

        def run_fn(packed):
            return self.fn(*packed[0], **packed[1])

        t0 = time.perf_counter()
        with obs.span("exec.trace", cat="exec", fn=self.name, mode=self.mode) as tsp:
            sp.graph, sp.names, sp.out_names, sp.out_spec = trace_to_graph(
                run_fn, (args, kwargs), name=self.name, return_outputs=True)
            sp.trace_seconds = time.perf_counter() - t0
            sp.compiled = self.compiler.compile(sp.graph)
            sp.status = "compiled"
            tsp.set(status=sp.status, placement=sp.placement)
        return sp

    def _get(self, args, kwargs) -> _Specialization:
        key = self._in_sig(args, kwargs) if self.respecialize else None
        sp = self._specs.get(key)
        if sp is None:
            sp = self._trace(args, kwargs)
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

    # -- execution -------------------------------------------------------------
    def _run(self, sp: _Specialization, args, kwargs):
        env = dict(zip(sp.names, pytree.tree_flatten((args, kwargs))[0]))
        outs = sp.compiled(env)
        return pytree.tree_unflatten([outs[o] for o in sp.out_names],
                                     sp.out_spec)

    def __call__(self, *args, **kwargs):
        self._check_device(args, kwargs)
        if self.mode == "jit":
            self.jit_calls += 1
            return self.fn(*args, **kwargs)
        sp = self._get(args, kwargs)
        if not sp.ok or sp.in_sig != self._in_sig(args, kwargs):
            self.fallback_calls += 1
            return self.fn(*args, **kwargs)
        with obs.span(f"exec.{self.name}", cat="exec", path="stitched"):
            out = self._run(sp, args, kwargs)
        self.stitched_calls += 1
        return out

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
                "compile_seconds": s.compile_seconds,
                "trace_seconds": sp.trace_seconds,
                "stage_seconds": dict(s.stage_seconds),
                "ilp_method": s.ilp.method if s.ilp is not None else None,
                "verify": s.verify}

    def report(self) -> dict:
        """Call routing and plan + kernel stats — one dict with the
        reference's report keys where they apply (a trace or compile
        failure raises, so ``error``/``errors`` stay empty)."""
        sp = self._active
        return {
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
            "specializations": len(self._specs),
            "specialization_cap": self.respecialize or None,
            "placement": sp.placement if sp is not None else "",
            "plan": self.plan_stats(),
            "plans": {s.placement or self.name: {"status": s.status,
                                                 "plan": self._plan_stats(s)}
                      for s in self._specs.values()},
            "error": None,
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


def stitch(fn: Callable, *, mode: str = "offline", compiler=None, device=None,
           eligibility_argnums=None, respecialize: int = 0,
           name: str | None = None) -> StitchedFunction:
    """Wrap ``fn`` for execution through the FusionStitching pipeline.

    Args:
      fn: a PyTorch function of pytree args/kwargs returning a pytree of
        tensors.
      mode: ``"offline"`` (blocking compile at the first call per
        signature) or ``"jit"`` (eager, no stitching).
      compiler: the :class:`repro_torch.core.StitchCompiler` to plan with
        (default: H100 hardware model, default ``GenConfig``).
      device: where the function runs — ``"cuda"`` by default (raises when
        there is no card), ``"cpu"`` on request.
      eligibility_argnums: restrict the per-call shape-drift check to these
        args (default all).
      respecialize: N > 0 makes a drifted input signature trace a NEW
        specialization instead of running eagerly, LRU-bounded at N.
      name: graph name for reports.
    """
    return StitchedFunction(
        fn, mode=mode, compiler=compiler, device=device,
        eligibility_argnums=eligibility_argnums, respecialize=respecialize,
        name=name)
