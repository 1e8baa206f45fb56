"""Cost model (paper §4.3) adapted to TPU.

Two evaluation paths, as in the paper:

* **model-based** — fast analytic score used for most patterns:
      f(P) = M(V_saved) + (N-1) * phi
  where M(V) extrapolates the latency of moving V bytes through HBM using an
  offline bandwidth-utilization curve (paper Fig. 4: small transfers do not
  saturate the memory system), and phi is the per-kernel dispatch overhead.

* **execution-based** — measure the generated kernel directly:
      f(P) = sum_j K(Op_j) + (N-1) * phi - K(P)
  On this CPU container "execution" means timing the interpret-mode Pallas
  kernel / jitted reference, which preserves *relative* ordering for the
  plan-selection decisions the paper makes with it; the tuner (Alg. 3) uses
  it for the complex-pattern class exactly as §4.3 prescribes.

Hardware presets: ``V100`` validates the cost model against the paper's own
environment; ``TPU_V5E`` is the reference package's deployment target;
``H100`` is the port's (NVIDIA H100 SXM data-sheet numbers).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .ir import Graph, OpKind
from .pattern import FusionPattern

__all__ = ["HardwareModel", "V100", "TPU_V5E", "H100", "CostModel",
           "PatternScore"]


@dataclass(frozen=True)
class HardwareModel:
    name: str
    hbm_bw: float            # bytes/s, peak
    peak_flops: float        # FLOP/s (matmul-precision)
    launch_latency: float    # phi, seconds per kernel dispatch
    onchip_budget: int       # bytes of scratch (GPU shared mem / TPU VMEM)
    # bandwidth-utilization curve (paper Fig. 4): transfer of V bytes runs at
    # eff(V) * hbm_bw.  Modeled as a saturating curve with half-utilization
    # point `bw_half` bytes, calibrated offline.
    bw_half: float = 1 << 17
    # interconnect for the roofline/collective term (per-chip, all links)
    ici_bw: float = 0.0
    # per-kernel register/VREG live-value budget (paper §4.3's occupancy
    # loss): the stitched emitter holds every live internal intermediate of
    # the current row block in vector registers, so a pattern whose peak
    # live working set exceeds this budget would spill / serialise the
    # pipeline — the cost model rejects it as *infeasible*, not merely
    # unattractive, which is what forces over-wide independent regions to
    # shatter into FFD packs instead of one monolithic kernel.
    reg_budget: int = 2 * 1024 * 1024

    def efficiency(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 1.0
        return nbytes / (nbytes + self.bw_half)

    def mem_time(self, nbytes: float) -> float:
        """M(V): latency to move V bytes at utilization-scaled bandwidth."""
        if nbytes <= 0:
            return 0.0
        return nbytes / (self.hbm_bw * self.efficiency(nbytes))

    def flops_time(self, flops: float) -> float:
        return flops / self.peak_flops if flops > 0 else 0.0


V100 = HardwareModel(
    name="V100",
    hbm_bw=900e9,
    peak_flops=15.7e12,          # fp32 FMA; the paper's workloads are fp32
    launch_latency=8e-6,         # paper: phi between 6 and 10 us
    onchip_budget=96 * 1024,     # shared memory per SM (opt-in 96KB on Volta)
    bw_half=1 << 18,
    ici_bw=150e9,                # NVLink aggregate (unused by fusion scoring)
    reg_budget=256 * 1024,       # 64K 32-bit registers per SM
)

TPU_V5E = HardwareModel(
    name="TPU_V5E",
    hbm_bw=819e9,
    peak_flops=197e12,           # bf16
    launch_latency=2e-6,         # XLA static-schedule dispatch, no driver
    onchip_budget=16 * 1024 * 1024,  # conservative usable VMEM scratch
    bw_half=1 << 17,
    ici_bw=3 * 2 * 50e9,         # 3 links x 2 directions x 50 GB/s
    reg_budget=2 * 1024 * 1024,  # VREG + low-latency VMEM working set
)


H100 = HardwareModel(
    name="H100",
    hbm_bw=3.35e12,              # HBM3, SXM data sheet
    peak_flops=989e12,           # dense bf16 tensor-core rate
    # bw_half and launch_latency are carried over from V100: not measured
    # on the H100 yet
    launch_latency=8e-6,
    onchip_budget=227 * 1024,    # opt-in shared memory per block
    bw_half=1 << 18,
    ici_bw=450e9,                # NVLink, each way (unused by fusion scoring)
    reg_budget=256 * 1024,       # 64K 32-bit registers per SM
)

@dataclass
class PatternScore:
    pattern: FusionPattern
    score: float               # seconds saved; the ILP objective weight f(P)
    feasible: bool
    reason: str = ""
    scratch_request: int = 0   # worst-case on-chip bytes before Alg.4 reuse
    saved_bytes: int = 0
    kernels_removed: int = 0
    reg_request: int = 0       # peak live register bytes (occupancy gate)


class CostModel:
    """Scores fusion patterns; enforces the paper's feasibility gates.

    ``reg_budget`` overrides the hardware's register/live-value budget
    (``GenConfig.reg_budget`` threads through here); None keeps the
    hardware default."""

    def __init__(self, hw: HardwareModel = TPU_V5E,
                 reg_budget: int | None = None):
        self.hw = hw
        self.reg_budget = hw.reg_budget if reg_budget is None else reg_budget

    # -- per-op kernel-time model -------------------------------------------
    def op_bytes(self, g: Graph, name: str) -> int:
        node = g[name]
        in_b = sum(g[o].bytes for o in node.operands)
        return in_b + node.bytes

    def gemm_flops(self, g: Graph, name: str) -> float:
        node = g[name]
        if node.kind not in (OpKind.GEMM, OpKind.BATCHED_GEMM):
            return 0.0
        lhs = g[node.operands[0]]
        k = math.prod(lhs.shape[d] for d in node.attrs["contract"][0])
        return 2.0 * node.size * k

    def op_flops(self, g: Graph, name: str) -> float:
        """MXU/compute FLOPs of one op: GEMMs by contraction size, registered
        custom kernels by their declared estimate, everything else 0."""
        node = g[name]
        if node.kind in (OpKind.GEMM, OpKind.BATCHED_GEMM):
            return self.gemm_flops(g, name)
        if node.kind is OpKind.CUSTOM and "project" not in node.attrs:
            from repro_torch.kernels.registry import lookup
            desc = lookup(node)
            if desc is not None:
                return desc.flops(node, g)
        return 0.0

    def custom_scratch(self, p: FusionPattern) -> int:
        """On-chip bytes the pattern's registered custom-kernel bodies bring
        along (e.g. flash attention's m/l/acc accumulators).  Kept separate
        from :meth:`scratch_request` because that dict feeds the *template*
        scratch plan; a custom kernel allocates its own scratch inside its
        saved body."""
        from repro_torch.kernels.registry import lookup
        total = 0
        for n in p.compute_members:
            if n.kind is OpKind.CUSTOM and "project" not in n.attrs:
                desc = lookup(n)
                if desc is not None:
                    total += desc.scratch_bytes(n, p.graph)
        return total

    def kernel_time(self, g: Graph, name: str) -> float:
        """K(Op): standalone kernel execution time for one op (roofline max
        of its memory and compute terms) — the unfused baseline cost."""
        node = g[name]
        if node.is_source() or node.kind is OpKind.TUPLE:
            return 0.0
        mem = self.hw.mem_time(self.op_bytes(g, name))
        comp = 0.0
        if node.kind in (OpKind.GEMM, OpKind.BATCHED_GEMM, OpKind.CUSTOM):
            comp = self.hw.flops_time(self.op_flops(g, name))
        elif node.kind is OpKind.REDUCTION:
            comp = self.hw.flops_time(float(g[node.operands[0]].size))
        elif node.kind is OpKind.ELEMENTWISE:
            comp = self.hw.flops_time(float(node.size) * max(1, len(node.operands)))
        return max(mem, comp)

    def fused_time(self, p: FusionPattern) -> float:
        """K(P): modeled execution of the fused kernel — external I/O moves
        through HBM once; internal edges live on-chip; compute unchanged."""
        g = p.graph
        io_bytes = p.input_bytes + p.output_bytes
        mem = self.hw.mem_time(io_bytes)
        comp = 0.0
        for n in p.compute_members:
            if n.kind in (OpKind.GEMM, OpKind.BATCHED_GEMM, OpKind.CUSTOM):
                comp += self.hw.flops_time(self.op_flops(g, n.name))
            else:
                comp += self.hw.flops_time(float(n.size))
        return max(mem, comp)

    # -- scratch requirement (pre-Alg.4) ------------------------------------
    def scratch_request(self, p: FusionPattern) -> dict[str, int]:
        """Bytes of on-chip transfer storage each member would request.

        Mirrors §5: intermediates crossing a *composition boundary* (produced
        by a reduction/gemm member, or consumed by one) need block-level
        scratch (GPU shared / TPU VMEM); pure elementwise chains stay in
        registers (VREG) and request nothing.
        """
        g = p.graph
        req: dict[str, int] = {}
        heavy = {OpKind.REDUCTION, OpKind.GEMM, OpKind.BATCHED_GEMM}
        for n in p.compute_members:
            internal_users = [u for u in g.users(n.name) if u in p.members]
            if not internal_users:
                continue
            crosses = n.kind in heavy or any(g[u].kind in heavy for u in internal_users)
            if crosses:
                # per-block tile of the intermediate: bounded by one row-block
                # (minor-most dim x 8 sublanes) or the whole tensor if small
                tile = min(n.bytes, self._tile_bytes(n))
                req[n.name] = tile
        return req

    def _tile_bytes(self, node) -> int:
        """One (8, minor) VMEM tile of the tensor (the per-block working set a
        block-composition schedule holds on-chip at a time)."""
        if not node.shape:
            return node.bytes
        minor = node.shape[-1]
        rows = 8 if len(node.shape) > 1 else 1
        return minor * rows * (node.bytes // max(node.size, 1))

    # -- register pressure (§4.3 occupancy gate) ------------------------------
    def register_pressure(self, p: FusionPattern) -> int:
        """Peak live-value bytes of one row block through the stitched body.

        The emitter evaluates members in topo order holding every internal
        intermediate of the current row block as a live vector value; a
        value dies after its last in-pattern consumer.  Wide *independent*
        regions (interleaved per-expert MoE chains) keep one working set
        per chain live simultaneously, so their peak grows with the number
        of chains — the occupancy loss the paper trades against launch
        savings.  Patterns over :attr:`reg_budget` are infeasible; the FFD
        packer re-forms the chains into bins that fit.
        """
        g = p.graph
        member_groups = getattr(p, "member_groups", None)
        if member_groups:
            # horizontal pack: member subgraphs are independent and laid out
            # along the kernel's grid dimension (one block range each), so
            # the per-block live working set is the *widest* subgraph — not
            # the interleaved sum.  This is the §4.2 occupancy argument: a
            # pack shares one launch without inflating per-block registers,
            # which an interleaved monolithic fusion cannot avoid.
            return max(
                self.register_pressure(FusionPattern(g, grp, "pack-member"))
                for grp in member_groups
            )
        seq = p.compute_members
        if len(seq) < 2:
            return 0
        counts: dict[int, float] = {}
        for name in p.external_outputs:
            shp = g[name].shape
            if shp and shp[0] > 1:
                counts[shp[0]] = counts.get(shp[0], 0.0) + 1000.0
        for name in p.external_inputs:
            shp = g[name].shape
            if shp and shp[0] > 1:
                counts[shp[0]] = counts.get(shp[0], 0.0) + 1.0
        if not counts:
            return 0
        rows = max(counts, key=lambda k: (counts[k], k))
        rb = min(8, rows)
        # single-block patterns (registered-custom replay; cross-row
        # accumulators feeding members, e.g. the packed optimizer's global
        # grad-norm) run as grid==1 composition: whole-array residency is
        # the scratch plan's domain, and with one block in flight there is
        # no occupancy to lose — the register gate only prices row-streamed
        # interleaving width
        members = set(p.members)
        for n in seq:
            if n.kind is OpKind.CUSTOM and "project" not in n.attrs:
                return 0
            if n.kind is OpKind.REDUCTION and 0 in tuple(n.attrs.get("axes", ())):
                src = g[n.operands[0]]
                if src.shape and src.shape[0] == rows and any(
                        u in members for u in g.users(n.name)):
                    return 0

        def tile(node) -> int:
            shp = node.shape
            if shp and shp[0] == rows:
                return (node.bytes // rows) * rb
            # not tiled by the row grid (weight converts, transposed
            # operands): streamed through one (8, minor) tile at a time
            return min(node.bytes, self._tile_bytes(node))

        pos = {n.name: i for i, n in enumerate(seq)}
        last_use: dict[str, int] = {}
        for n in seq:
            for o in n.operands:
                if o in pos:
                    last_use[o] = max(last_use.get(o, -1), pos[n.name])
        live = 0
        peak = 0
        expiry: dict[int, list[int]] = {}
        for i, n in enumerate(seq):
            b = tile(n)
            if n.name in last_use:
                live += b
                expiry.setdefault(last_use[n.name], []).append(b)
                peak = max(peak, live)
            else:
                peak = max(peak, live + b)  # transient: streamed straight out
            for dead in expiry.pop(i, ()):
                live -= dead
        return peak

    # -- the paper's two scoring paths ---------------------------------------
    def score_model_based(self, p: FusionPattern) -> PatternScore:
        n_kernels = len(p.compute_members)
        if n_kernels < 2:
            return PatternScore(p, -1.0, False, "singleton", 0, 0, 0)
        req = self.scratch_request(p)
        total_req = sum(req.values()) + self.custom_scratch(p)
        if total_req > self.hw.onchip_budget:
            return PatternScore(
                p, -1.0, False,
                f"scratch {total_req}B exceeds budget {self.hw.onchip_budget}B",
                total_req, 0, 0,
            )
        reg = self.register_pressure(p)
        if reg > self.reg_budget:
            return PatternScore(
                p, -1.0, False,
                f"register pressure {reg}B exceeds budget {self.reg_budget}B",
                total_req, 0, 0, reg,
            )
        saved = p.saved_bytes
        score = self.hw.mem_time(saved) + (n_kernels - 1) * self.hw.launch_latency
        return PatternScore(p, score, True, "model", total_req, saved,
                            n_kernels - 1, reg)

    def score_execution_based(self, p: FusionPattern) -> PatternScore:
        n_kernels = len(p.compute_members)
        if n_kernels < 2:
            return PatternScore(p, -1.0, False, "singleton", 0, 0, 0)
        req = self.scratch_request(p)
        total_req = sum(req.values()) + self.custom_scratch(p)
        if total_req > self.hw.onchip_budget:
            return PatternScore(p, -1.0, False, "scratch over budget", total_req, 0, 0)
        reg = self.register_pressure(p)
        if reg > self.reg_budget:
            return PatternScore(
                p, -1.0, False,
                f"register pressure {reg}B exceeds budget {self.reg_budget}B",
                total_req, 0, 0, reg,
            )
        unfused = sum(self.kernel_time(p.graph, n.name) for n in p.compute_members)
        fused = self.fused_time(p)
        score = unfused + (n_kernels - 1) * self.hw.launch_latency - fused
        feasible = score >= 0
        return PatternScore(
            p, score, feasible, "execution", total_req, p.saved_bytes,
            n_kernels - 1, reg
        )

    # -- dispatch rule (§4.3: model-based for most, execution for complex) ---
    def score(self, p: FusionPattern) -> PatternScore:
        complex_pattern = (p.pattern_class == "gemm"
                           or len(p.reduce_kinds) > 1
                           or bool(p.custom_members))
        if complex_pattern:
            return self.score_execution_based(p)
        return self.score_model_based(p)
