"""Implementation templates (paper §5.2) — TPU dialect.

The paper's template is a compact schedule description per op::

    reduce_1[GRID,WARP,WARP,CTA]S; mul_1[GRID,CTA];

On TPU there are no warps or CTAs; the corresponding parallelization levels
of a Pallas kernel are the sequential *grid*, the 8-row *sublane* dimension
and the 128-wide *lane* dimension of the VPU tile, plus a purely sequential
in-kernel loop.  The storage attribute generalizes the paper's ``S``:

    GPU attr   TPU attr    meaning
    --------   ---------   ------------------------------------------------
    GRID       GRID        dimension mapped to the pallas grid (outer loop)
    WARP       SUBLANE     dimension mapped to VPU sublanes (8)
    CTA        LANE        dimension mapped to VPU lanes (128)
    THREAD     SEQ         sequential within the kernel body (no parallelism)
    S          S           keep result in on-chip scratch: VMEM (block comp.)
    (default)  (default)   result stays in VREG (thread composition) or HBM
                           (pattern output)

Multi-level tiling is kept: ``GRID_128-SUBLANE_2`` splits one dimension into
a grid component of 128 tiles with 2 sublane-parallel sub-tiles, exactly the
paper's ``GRID_128-WARP_2``.

The grammar below is the paper's, re-terminalized::

    template      := schedule+
    schedule      := ident '[' attr-list ']' storage? ';'
    attr-list     := attr (',' attr)*
    attr          := subattr ('-' subattr)*
    subattr       := ATTRTYPE ('_' INT)?
    ATTRTYPE      := 'GRID' | 'SUBLANE' | 'LANE' | 'SEQ'
    storage       := 'S'

Templates are *value objects*: parse -> :class:`Template`, print -> the same
string.  The tuner (Alg. 3) enumerates them; the emitter consumes them.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

__all__ = ["Attr", "SubAttr", "Schedule", "Template", "parse_template",
           "ATTR_TYPES", "GPU_TO_TPU_ATTR"]

ATTR_TYPES = ("GRID", "SUBLANE", "LANE", "SEQ")
GPU_TO_TPU_ATTR = {"GRID": "GRID", "WARP": "SUBLANE", "CTA": "LANE", "THREAD": "SEQ"}


@dataclass(frozen=True)
class SubAttr:
    kind: str                 # one of ATTR_TYPES
    factor: int | None = None  # tiling factor, e.g. GRID_128

    def __post_init__(self):
        if self.kind not in ATTR_TYPES:
            raise ValueError(f"unknown attr type {self.kind!r}")

    def __str__(self) -> str:
        return self.kind if self.factor is None else f"{self.kind}_{self.factor}"


@dataclass(frozen=True)
class Attr:
    """Per-dimension (possibly multi-level) tiling spec."""
    levels: tuple[SubAttr, ...]

    def __str__(self) -> str:
        return "-".join(str(l) for l in self.levels)

    @property
    def primary(self) -> str:
        return self.levels[0].kind


@dataclass(frozen=True)
class Schedule:
    op: str
    attrs: tuple[Attr, ...]
    scratch: bool = False     # the paper's S attribute -> VMEM scratch

    def __str__(self) -> str:
        body = ",".join(str(a) for a in self.attrs)
        return f"{self.op}[{body}]{'S' if self.scratch else ''};"

    def dims_with(self, kind: str) -> list[int]:
        return [i for i, a in enumerate(self.attrs) if any(l.kind == kind for l in a.levels)]


@dataclass(frozen=True)
class Template:
    schedules: tuple[Schedule, ...]

    def __str__(self) -> str:
        return " ".join(str(s) for s in self.schedules)

    def __iter__(self):
        return iter(self.schedules)

    def schedule_for(self, op: str) -> Schedule | None:
        for s in self.schedules:
            if s.op == op:
                return s
        return None

    @property
    def scratch_ops(self) -> list[str]:
        return [s.op for s in self.schedules if s.scratch]


_SCHED_RE = re.compile(
    r"\s*(?P<op>[A-Za-z_][\w.]*)\s*\[(?P<attrs>[^\]]*)\]\s*(?P<S>S)?\s*;"
)


def _parse_attr(text: str) -> Attr:
    levels = []
    for part in text.strip().split("-"):
        m = re.fullmatch(r"([A-Za-z]+)(?:_(\d+))?", part.strip())
        if not m:
            raise ValueError(f"bad attr {part!r}")
        kind = m.group(1).upper()
        kind = GPU_TO_TPU_ATTR.get(kind, kind)  # accept the paper's spelling
        levels.append(SubAttr(kind, int(m.group(2)) if m.group(2) else None))
    return Attr(tuple(levels))


def parse_template(text: str) -> Template:
    """Parse a template string (accepts both GPU and TPU attr spellings)."""
    schedules = []
    pos = 0
    for m in _SCHED_RE.finditer(text):
        if text[pos:m.start()].strip():
            raise ValueError(f"garbage in template: {text[pos:m.start()]!r}")
        attrs = tuple(
            _parse_attr(a) for a in m.group("attrs").split(",") if a.strip()
        )
        schedules.append(Schedule(m.group("op"), attrs, m.group("S") is not None))
        pos = m.end()
    if text[pos:].strip():
        raise ValueError(f"trailing garbage in template: {text[pos:]!r}")
    if not schedules:
        raise ValueError("empty template")
    return Template(tuple(schedules))
