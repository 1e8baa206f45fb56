"""FusionStitching core — the paper's contribution as a composable library.

Public surface:
    GraphBuilder / Graph / OpNode     — StitchIR
    generate_patterns / GenConfig     — §4.2 pattern search
    CostModel / HardwareModel         — §4.3 scoring (V100, TPU_V5E, H100)
    solve_fusion_plan                 — §4.1 ILP + cycle cuts
    Template / parse_template         — §5.2 implementation templates
    ScratchAllocator                  — §5.4 dominance-tree scratch reuse
    TemplateTuner                     — Alg. 3 kernel tuning
    StitchCompiler / CompiledGraph    — end-to-end optimize-and-execute
"""

from .codegen import build_reference_fn, eval_node
from .compiler import CompiledGraph, FusionStats, StitchCompiler, xla_like_groups
from .cost import H100, TPU_V5E, V100, CostModel, HardwareModel
from .fusiongen import GenConfig, exploratory_fusion, generate_patterns, multi_step_substitution, packing_fusion, substitution_fusion
from .ilp import ILPSolver, PlanResult, greedy_fusion_plan, solve_fusion_plan
from .ir import Graph, GraphBuilder, OpKind, OpNode, ReduceKind
from .pattern import FusionPattern, PackPattern, PatternClass, contraction_creates_cycle
from .scratch import ScratchAllocator, ScratchPlan, dominator_tree, post_dominates
from .templates import Template, parse_template
from .tuner import TemplateTuner, TunedKernel, generate_templates

__all__ = [
    "Graph", "GraphBuilder", "OpNode", "OpKind", "ReduceKind",
    "FusionPattern", "PackPattern", "PatternClass",
    "contraction_creates_cycle",
    "GenConfig", "generate_patterns", "substitution_fusion",
    "multi_step_substitution", "exploratory_fusion", "packing_fusion",
    "CostModel", "HardwareModel", "TPU_V5E", "V100", "H100",
    "ILPSolver", "PlanResult", "solve_fusion_plan", "greedy_fusion_plan",
    "Template", "parse_template",
    "ScratchAllocator", "ScratchPlan", "dominator_tree", "post_dominates",
    "TemplateTuner", "TunedKernel", "generate_templates",
    "StitchCompiler", "CompiledGraph", "FusionStats", "xla_like_groups",
    "build_reference_fn", "eval_node",
]
