"""The MoE router (``csrc/router.cu``) and the GLU (``csrc/activations.cu``)
on the CPU.

The router's kernel ranks each column by a count: the row's columns that
beat it (a larger probability, or an equal one at a lower index), compared
as the 64-bit keys ``bits(p) << 32 | ~j``; the columns of rank below k are
the ids in rank order, and the renormalising sum runs in slot order.  Here
that rule, written in torch as the kernel computes it, equals the round
kernel's rule (the plain version's k argmax rounds, the sum in slot order)
bit for bit (the round kernel itself is retired; the card held the rank
kernel to it while it stayed), and the plain version
(``topk_router_plain``, whose sum is ``w.sum``) in its ids and to an ulp
in its weights, on rows with exact ties, rows of equal logits and rows
with -inf logits, at E from 1 to 64.  Also: the ``ctypes`` bindings
against the C declarations and the wrappers' refusals before any build.
The kernels themselves run on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import activations, build, router

_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}


def _declared(stem: str, fn: str) -> list:
    """The ctypes types of ``fn``'s parameters as ``csrc/<stem>.cu``
    declares them."""
    src = (build.CSRC / f"{stem}.cu").read_text()
    decl = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src).group(1)
    return [_CTYPES[re.sub(r"\s*\w+$", "", p.strip())]
            for p in decl.split(",")]


@pytest.mark.parametrize("mod,stem,fn", [
    (activations, "activations", "repro_glu"),
    (router, "router", "repro_topk_router"),
])
def test_binding_matches_the_c_declaration(mod, stem, fn):
    """``bind`` declares each argument as the source declares it (a pointer
    or the stream as c_void_p, 64-bit counts as c_longlong), so ctypes
    cuts no pointer and shifts no argument."""
    class Lib:
        pass

    lib = Lib()
    for name in (fn, "repro_cuda_error_string"):
        setattr(lib, name, type("Fn", (), {})())
    mod.bind(lib)
    assert getattr(lib, fn).argtypes == _declared(stem, fn)
    assert getattr(lib, fn).restype is ctypes.c_int


def test_glu_wrapper_refuses_what_the_kernels_do_not_take():
    """A column stride, unequal operands, another dtype or an unknown
    activation is refused before any build."""
    g = torch.randn(4, 16)
    launch = activations._launch
    with pytest.raises(ValueError, match="contiguous"):
        launch(torch.randn(16, 4).t(), torch.randn(16, 4).t(), "silu")
    with pytest.raises(ValueError, match="equal"):
        launch(g, g[:, :8], "silu")
    with pytest.raises(ValueError, match="equal"):
        launch(g.half(), g.half(), "gelu")
    with pytest.raises(ValueError, match="act"):
        launch(g, g, "relu")


def test_router_wrapper_refuses_what_the_kernels_do_not_take():
    launch = router._launch
    x = torch.randn(4, 32)
    with pytest.raises(ValueError, match="contiguous"):
        launch(torch.randn(32, 16).t(), 2)
    with pytest.raises(ValueError, match="E <= 64"):
        launch(torch.randn(4, 65), 2)
    with pytest.raises(ValueError, match="k <= E"):
        launch(x, 33)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        launch(x.half(), 2)
    with pytest.raises(ValueError, match=r"\(T, E\)"):
        launch(x[None], 2)


def rank_router(logits, k: int, renormalize: bool):
    """The rank kernel's rule in torch: the plain version's probabilities;
    each column's slot the count of the row's columns that beat it, by the
    key ``bits(p) << 32 | ~j`` within the column's group of 32 (a lane's
    columns j and j + 32 past 32 experts) and by ``bits(p)`` alone,
    strictly for a later group and not for an earlier one, across groups;
    the columns of slot below k in slot order; the renormalising sum in
    slot order."""
    x = logits.to(torch.float32)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    T, E = p.shape
    cols = torch.arange(E)
    bits = p.view(torch.int32).to(torch.int64)
    key = (bits << 32) | (0xFFFFFFFF - cols)
    group = cols // 32
    same = group[:, None] == group[None, :]                   # (c, i)
    later = group[:, None] > group[None, :]
    beats = torch.where(same, key[:, :, None] > key[:, None, :],
                        torch.where(later, bits[:, :, None] > bits[:, None, :],
                                    bits[:, :, None] >= bits[:, None, :]))
    slot = beats.sum(dim=1)                                   # (T, E)
    assert torch.equal(slot.sort(dim=-1).values, cols.expand(T, E))
    ids = torch.empty(T, E, dtype=torch.int64).scatter_(
        1, slot, cols.expand(T, E))[:, :k]
    return _slot_order_renorm(p.gather(1, ids), ids, logits.dtype,
                              renormalize)


def rounds_router(logits, k: int, renormalize: bool):
    """The round kernel's rule in torch: the plain version's k rounds of
    max / first argmax / mask, unrenormalised in f32, then the
    renormalising sum in slot order."""
    w, ids = router.topk_router_plain(logits.float(), k, False)
    return _slot_order_renorm(w, ids, logits.dtype, renormalize)


def _slot_order_renorm(w, ids, dtype, renormalize: bool):
    """f32 weights (T, k) over ``max(((w_0 + w_1) + w_2) + ..., 1e-30)``
    where asked, cast to ``dtype``; ids as int32."""
    if renormalize:
        total = torch.zeros(w.shape[0])
        for r in range(w.shape[1]):
            total = total + w[:, r]
        w = w / total[:, None].clamp_min(1e-30)
    return w.to(dtype), ids.to(torch.int32)


def _router_logits(E: int, dtype: torch.dtype) -> torch.Tensor:
    """64 rows of E logits: random, bf16-rounded (exact ties), rows of
    equal logits, and rows with -inf logits (their probabilities tie at
    0)."""
    rng = np.random.default_rng(E)
    x = torch.as_tensor(2.0 * rng.standard_normal((64, E)),
                        dtype=torch.float32)
    x[16:32] = x[16:32].to(torch.bfloat16).float()
    x[32:40] = 0.25
    x[40:48, 1::3] = -torch.inf
    x[48:52, 1:] = -torch.inf
    x[52:56] = torch.round(x[52:56])
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("E", [1, 8, 32, 33, 60, 64])
def test_rank_rule_equals_the_rounds_bit_for_bit(E, renorm, dtype):
    x = _router_logits(E, dtype)
    top = torch.sort(x.float(), dim=-1, descending=True).values
    if E > 1:
        assert (top[:, :-1] == top[:, 1:]).any(-1).sum() > 8   # exact ties
    for k in sorted({1, min(4, E), min(8, E), E}):
        w, ids = rank_router(x, k, renorm)
        rw, rids = rounds_router(x, k, renorm)
        assert torch.equal(ids, rids), (k, int((ids != rids).any(-1).sum()))
        assert torch.equal(w, rw), k
        # the plain version: the same ids and, but for its order of the
        # renormalising sum, the same weights (exactly when unrenormalised)
        pw, pids = router.topk_router_plain(x, k, renorm)
        assert torch.equal(ids, pids), k
        ulps = k if renorm else 0
        torch.testing.assert_close(w.float(), pw.float(), atol=0,
                                   rtol=ulps * torch.finfo(dtype).eps)
    # a row of equal logits takes the lowest indices, in order
    assert ids[32].tolist() == list(range(E))
