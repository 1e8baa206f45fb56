"""Build the port's hand-written kernels: CUDA C++ and Triton.

Each CUDA C++ source (``repro_torch/csrc/*.cu``) compiles with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``build/kernels/`` at the repository root.  The library's file name
carries a hash of the source and the flags, so a changed source builds anew
and an unchanged one is loaded as it is.  A failed build raises
:class:`BuildError` with nvcc's output.  A Triton kernel is JIT-compiled
by Triton at its first launch (:func:`triton_jit`).  Nothing here runs at
import time.
"""

from __future__ import annotations

import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BuildError", "CSRC", "NVCC_FLAGS", "build_dir", "library",
           "next_pow2", "nvcc", "signature", "triton_jit", "triton_vector"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildError(RuntimeError):
    pass


def build_dir() -> Path:
    """``build/kernels`` at the repository root."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    path, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _target(src: Path, out_dir: Path) -> Path:
    h = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return out_dir / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def library(stem: str, src_dir: Path = CSRC, out_dir: Path | None = None) -> Path:
    """The shared library of ``<src_dir>/<stem>.cu`` in ``out_dir``
    (default :func:`build_dir`), compiled first when it is missing.  nvcc's
    report (``-Xptxas -v``: registers, shared memory, spills per kernel) is
    kept beside the library as ``.log``."""
    src = src_dir / f"{stem}.cu"
    out_dir = out_dir or build_dir()
    target = _target(src, out_dir)
    if target.exists():
        return target
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    except OSError as e:
        raise BuildError(f"cannot run {cmd[0]}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed on {src.name} (exit {proc.returncode}):"
                         f"\n{proc.stdout}{proc.stderr}")
    target.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    tmp.replace(target)
    return target


def signature(*args) -> tuple:
    """The key a hand-written kernel's launch is counted under: each tensor
    argument's shape and dtype, every other argument as it is."""
    return tuple((tuple(a.shape), str(a.dtype)) if hasattr(a, "dtype") else a
                 for a in args)


def triton_jit(fn):
    """``triton.jit(fn)`` for a kernel body written at module level against
    the names ``tl`` and ``libdevice``: they are bound in the body's module
    here, at its first launch, because ``triton`` is imported only then
    (the CPU tests import every kernel module without it)."""
    import triton
    import triton.language as tl
    try:
        from triton.language.extra import libdevice
    except ImportError:  # older Triton releases
        from triton.language.extra.cuda import libdevice
    fn.__globals__.update(tl=tl, libdevice=libdevice)
    return triton.jit(fn)


def next_pow2(n: int) -> int:
    """The least power of two >= n (Triton's block sizes)."""
    return 1 << max(0, (n - 1).bit_length())


def triton_vector(itemsize: int, ptr16: bool, stride16: bool,
                  block_d: int) -> int:
    """Triton's elements a thread for one pointer of a (rows, BLOCK_D)
    program: the bytes it proves the address divisible by (16 for a pointer
    it specialised as 16-byte aligned, else 1; a row offset times 16
    elements where the row stride was specialised divisible by 16, else one
    element), up to 16 bytes and the block's width."""
    div = math.gcd(16 if ptr16 else 1, (16 if stride16 else 1) * itemsize)
    return max(1, min(div // itemsize, 16 // itemsize, block_d))
