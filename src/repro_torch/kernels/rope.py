"""Rotary position embedding: the port of the reference's ``_rope_kernel``
(``src/repro/kernels/rope.py:19``).

The kernel is CUDA C++ for ``sm_90a`` (``repro_torch/csrc/rope.cu``, built
by :mod:`.build` at first use and bound with ``ctypes``); its source note
gives the bound and the design.  ``freq = theta^(-i/half)`` is computed
once on the card for each (theta, half) and kept (:func:`_freq`).  A block
takes R token rows of ``(B*L, H*Dh)`` and a chunk of Hc heads
(:func:`block_plan`); its threads issue their 16-byte loads of x first,
compute the ``cos``/``sin`` table of its rows once (the power and the trig
functions in f64, rounded to f32 once, as the reference's f32 values),
then rotate the two halves of every head (``[x1*c - x2*s, x2*c + x1*s]``,
not interleaved pairs).  Positions are cast to f32 in the kernel, as the
reference does.  :func:`rope_plain` computes the same steps, each rounded
where the kernel rounds it.

It is the custom op ``repro_torch::rope(x, positions, theta, head_dim)``
over ``x (B*L, H*Dh)``, ``positions (B*L,)``: the CPU implementation is the
plain version, the CUDA implementation launches the kernel.  :func:`rope`
makes the 2-D views outside the op, as the reference wrapper does.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from . import build

__all__ = ["bind", "block_plan", "rope", "rope_plain", "launches",
           "vector_width"]

_FLOAT = {torch.float32: 0, torch.bfloat16: 1}
_POSITIONS = {torch.int32: 0, torch.int64: 1}
SMS = 132            # the H100 SXM's SMs: a grid aims at 2 blocks each
ROWS = 2             # token rows a block
ROW_THREADS = 128    # rotating threads a row of a block, where heads allow
MAX_THREADS = 512    # rope.cu's kMaxThreads: ROWS rows of a head's threads

# kernel launches since the last reset, by build.signature of the arguments
launches: Counter = Counter()
_LIB: ctypes.CDLL | None = None
# freq = theta^-(i / half) on the card, by (device, theta, half)
_FREQ: dict = {}


def rope_plain(x, positions, theta: float, head_dim: int):
    """The plain version, the kernel's spec (``csrc/rope.cu``) step by step
    in f32: ``e = i / half``, ``freq = theta^-e`` through f64 and rounded
    once, ``ang = pos * freq``, then ``cos`` and ``sin`` through f64 and
    rounded once, so that each f32 value is the correctly rounded one (an
    ulp off in freq is pos ulps off in the angle); then the rotation in
    f32, rounded once to x's dtype.  The reference writes ``freq`` as
    ``1 / theta^e``; XLA compiles that to ``theta^-e``, one rounding, and
    so does this."""
    rows, width = x.shape
    half = head_dim // 2
    e = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(float(theta), dtype=torch.float64,
                                  device=x.device), -e.double()).float()
    ang = positions.to(torch.float32)[:, None] * freq          # (rows, half)
    c = torch.cos(ang.double()).float()[:, None, :]
    s = torch.sin(ang.double()).float()[:, None, :]
    xr = x.reshape(rows, width // head_dim, head_dim).to(torch.float32)
    x1, x2 = xr[..., :half], xr[..., half:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype).reshape(rows, width)


def vector_width(half: int, itemsize: int, ptr: int, row_stride: int) -> int:
    """Elements a thread of the kernel loads at once: 16 bytes' worth (8 bf16,
    4 f32) where a half-head is a whole number of them and x's pointer and
    row stride (in elements) keep every load 16-byte aligned; else 1, the
    kernel's scalar path."""
    v = 16 // itemsize
    aligned = half % v == 0 and ptr % 16 == 0 and row_stride * itemsize % 16 == 0
    return v if aligned else 1


@functools.lru_cache(maxsize=1024)
def block_plan(rows: int, heads: int, half: int, vec: int) -> tuple[int, int]:
    """(R rows, Hc heads) a block of the kernel, its threads loading ``vec``
    elements each.  R is ``ROWS`` (fewer only where ``rows`` is), so a
    block's table holds rows at different positions.  Hc is the widest
    divisor of ``heads`` whose threads fit ``ROW_THREADS`` a row (one head
    where none does): no head is padded, and a row's table serves as many
    heads as fit.  Only while the grid holds fewer than 2 blocks an SM (a
    decode step's few rows) do the heads split, to the next smaller
    divisor.  How this plan compares with the others on the card:
    ``examples/torch_rope_plans.py``."""
    lanes = half // vec
    if rows < 1 or heads < 1:
        raise ValueError(f"rope: {rows} rows of {heads} heads: nothing to "
                         f"rotate")
    if half % vec or not 1 <= lanes <= MAX_THREADS // ROWS:
        raise ValueError(f"rope: half {half} takes {half / vec:g} threads of "
                         f"{vec} elements, need a whole number up to "
                         f"{MAX_THREADS // ROWS}")
    divisors = [d for d in range(heads, 0, -1) if heads % d == 0]
    hc = next(d for d in divisors if d * lanes <= ROW_THREADS or d == 1)
    r = min(rows, ROWS)
    while hc > 1 and -(-rows // r) * (heads // hc) < 2 * SMS:
        hc = next(d for d in divisors if d < hc)
    return r, hc


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``rope`` library."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_rope.argtypes = [vp, vp, vp, vp, ci, ci, cl, ci, ci, cl, cl,
                               ci, ci, ci, vp]
    lib.repro_rope.restype = ci
    lib.repro_rope_freq.argtypes = [vp, ci, ctypes.c_float, vp]
    lib.repro_rope_freq.restype = ci
    lib.repro_empty_kernel.argtypes = [ci, vp]
    lib.repro_empty_kernel.restype = ci
    lib.repro_cuda_error_string.argtypes = [ci]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build.library("rope"))))
    return _LIB


def _freq(device, theta: float, half: int) -> torch.Tensor:
    """``theta^-(i / half)`` for i < half, f32 on ``device``: computed on
    the card at the first call for (theta, half) with the spec's
    operations (``repro_rope_freq``), then kept.  The first call waits for
    the table (so it cannot come inside a CUDA-graph capture), and a launch
    on any stream may then read it."""
    key = (torch.device(device), float(theta), half)
    if key not in _FREQ:
        freq = torch.empty(half, dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device)
        err = _lib().repro_rope_freq(freq.data_ptr(), half, float(theta),
                                     stream.cuda_stream)
        if err:
            raise RuntimeError(f"rope freq kernel launch failed: "
                               f"{_lib().repro_cuda_error_string(err).decode()}")
        stream.synchronize()
        _FREQ[key] = freq
    return _FREQ[key]


def _launch(x, positions, theta: float, head_dim: int):
    out = _launch_kernel(x, positions, theta, head_dim)
    launches[build.signature(x, positions, theta, head_dim)] += 1
    return out


def _launch_kernel(x, positions, theta: float, head_dim: int):
    """One launch of the kernel with the op's checks, not counted (the card
    check times it and holds it against its plain version this way)."""
    if x.dim() != 2 or head_dim % 2 or x.shape[1] % head_dim \
            or tuple(positions.shape) != (x.shape[0],):
        raise ValueError(f"rope: x {tuple(x.shape)}, positions "
                         f"{tuple(positions.shape)}, head_dim {head_dim}")
    if x.dtype not in _FLOAT or positions.dtype not in _POSITIONS:
        raise TypeError(f"rope: x {x.dtype}, positions {positions.dtype}: "
                        f"need float32 or bfloat16, int32 or int64")
    if positions.device != x.device:
        raise ValueError(f"rope: positions on {positions.device}, x on {x.device}")
    if x.stride(1) != 1:
        raise ValueError(f"rope: x strides {x.stride()}: rows must be contiguous")
    rows, width = x.shape
    H, half = width // head_dim, head_dim // 2
    out = torch.empty((rows, width), dtype=x.dtype, device=x.device)
    vec = vector_width(half, x.element_size(), x.data_ptr(), x.stride(0))
    R, Hc = block_plan(rows, H, half, vec)
    freq = _freq(x.device, theta, half)
    err = _lib().repro_rope(
        x.data_ptr(), positions.data_ptr(), freq.data_ptr(), out.data_ptr(),
        _FLOAT[x.dtype], _POSITIONS[positions.dtype], rows, H, half,
        x.stride(0), positions.stride(0), R, Hc, vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        msg = _lib().repro_cuda_error_string(err).decode()
        if err < 0:
            raise ValueError(f"rope: {msg} (x {x.dtype} {tuple(x.shape)} "
                             f"strides {x.stride()}, head_dim {head_dim}, "
                             f"plan R {R} Hc {Hc} vec {vec})")
        raise RuntimeError(f"rope kernel launch failed: {msg} ({err})")
    return out


@torch.library.custom_op("repro_torch::rope", mutates_args=(), device_types="cpu")
def rope_op(x: torch.Tensor, positions: torch.Tensor, theta: float,
            head_dim: int) -> torch.Tensor:
    return rope_plain(x, positions, theta, head_dim)


rope_op.register_kernel("cuda")(_launch)


@rope_op.register_fake
def _(x, positions, theta, head_dim):
    return x.new_empty(x.shape)


def rope(x, positions, theta: float = 10000.0):
    """x: (B, L, H, Dh); positions: (B, L).  Returns rotated x."""
    B, L, H, Dh = x.shape
    out = rope_op(x.reshape(B * L, H * Dh), positions.reshape(B * L),
                  float(theta), Dh)
    return out.reshape(B, L, H, Dh)
