"""The port's kernel API (``ops.rmsnorm_residual``, ``ops.softmax`` with and
without a mask, ``ops.cross_entropy``) against the reference's.

* Each kernel's plain version (what the Triton kernel computes) against the
  reference's Pallas kernel in interpret mode: ``_rmsnorm_residual_kernel``,
  ``_softmax_kernel``, ``_softmax_masked_kernel`` and ``_xent_kernel``, at
  ragged widths, the reference benchmark's (2048, 1024) softmax and V =
  2500, f32 at the reference's own tolerances (``tests/test_kernels.py``)
  and bf16 within one bf16 rounding step (1.6e-2).  A fully masked row is
  0 in kernel mode and NaN in ref mode, in both packages; an unmasked row
  of ``-inf`` is NaN in both.
* The port's ref oracles against the reference's ``ref`` (NaN rows too).
* The three functions ``chip_smoke.py`` drives on the card (the residual
  seam with the LM-head loss, masked GQA attention, a softmax over
  vocabulary rows), at T = 16, D = 64, V = 2500 and (2, 2, 8, 8) scores:
  traced in kernel mode (port) and pallas mode (reference) they hold the
  same tagged CUSTOM nodes, projections and operand shapes; the
  reference's tagged graph plans identically in both planners (12 ops to
  3 kernels in pallas mode, 32 to 3 in ref mode), and the port's own
  kernel-mode graph plans as the reference's; ``stitch()`` on the CPU
  equals ``jax.jit`` of the reference function in both modes.

The reference's ``trace_to_graph`` and ``jax.jit`` cache a trace by
function object and not by kernel mode, so each reference trace takes a
fresh function object (``_ref_fns``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import masked_attention, padding_mask, seam_loss, vocab_probs
from repro.core import StitchCompiler as RefCompiler
from repro.core import V100 as REF_V100
from repro.core.trace import trace_to_graph as ref_trace
from repro.kernels import cross_entropy as ref_xent
from repro.kernels import norms as ref_norms
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.kernels import softmax as ref_softmax
from repro_torch.core import OpKind, StitchCompiler, V100
from repro_torch.core.trace import trace_to_graph
from repro_torch.exec import stitch
from repro_torch.kernels import cross_entropy, norms, ops, ref, softmax

from test_torch_kernel_mode import ref_kernel_name
from test_torch_planner import _groups, to_port

DTYPES = [("float32", 2e-5), ("bfloat16", 1.6e-2)]
# the reference's softmax tolerance in f32: rtol 2e-5, atol 2e-6
SOFTMAX_DTYPES = [("float32", (2e-5, 2e-6)), ("bfloat16", (1.6e-2, 1.6e-2))]
TOL = dict(rtol=2e-4, atol=2e-4)
T, D, V = 16, 64, 2500
LENS = np.array([8, 5])


def _pair(a: np.ndarray, dtype: str | None = None):
    if dtype is None:
        return jnp.asarray(a), torch.as_tensor(a)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.as_tensor(a).to(getattr(torch, dtype)))


def _close(port, reference, tol):
    rtol, atol = tol if isinstance(tol, tuple) else (tol, tol)
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(reference, np.float32),
                               rtol=rtol, atol=atol)


# -- the plain versions against the Pallas kernels ------------------------------------

@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", [(3, 5, 96), (33, 512), (4, 2048)],
                         ids=["3x5x96", "33x512", "4x2048"])
def test_rmsnorm_residual_plain_matches_reference_kernel(shape, dtype, tol):
    rng = np.random.default_rng(shape[-1])
    x, r = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    g = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    (jx, tx), (jr, tr), (jg, tg) = (_pair(a, dtype) for a in (x, r, g))
    want = ref_norms.rmsnorm_residual(jx, jr, jg, 1e-6, block_rows=8)
    for got in (norms.rmsnorm_residual_plain(tx, tr, tg, 1e-6),
                norms.rmsnorm_residual(tx, tr, tg, 1e-6),
                ref.rmsnorm_residual(tx, tr, tg, 1e-6)):
        for a, b in zip(got, want):
            assert a.shape == tx.shape and a.dtype == tx.dtype
            _close(a, b, tol)
    # the new residual is x + res rounded once: equal in both packages
    np.testing.assert_array_equal(got[1].float().numpy(),
                                  np.asarray(want[1], np.float32))


@pytest.mark.parametrize("dtype,tol", SOFTMAX_DTYPES)
@pytest.mark.parametrize("shape,scale", [((8, 128), 1.0), ((7, 333), 0.125),
                                         ((4, 16, 64), 0.5),
                                         ((2048, 1024), 0.125)],
                         ids=["8x128", "7x333", "4x16x64", "bench_2048x1024"])
def test_softmax_plain_matches_reference_kernel(shape, scale, dtype, tol):
    rng = np.random.default_rng(shape[-1])
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want = ref_softmax.softmax(jx, scale)
    for got in (softmax.softmax_plain(tx, scale), softmax.softmax(tx, scale),
                ref.softmax(tx, scale)):
        assert got.shape == tx.shape and got.dtype == tx.dtype
        _close(got, want, tol)


def _mask(shape, rng):
    """Random keep lanes with row 2 fully masked and row 0 fully kept."""
    m = rng.random(shape) < 0.6
    m.reshape(-1, shape[-1])[2] = False
    m.reshape(-1, shape[-1])[0] = True
    return m


@pytest.mark.parametrize("dtype,tol", SOFTMAX_DTYPES)
@pytest.mark.parametrize("shape", [(4, 64), (6, 333), (2, 3, 4, 40)],
                         ids=["4x64", "6x333", "2x3x4x40"])
def test_softmax_masked_plain_matches_reference_kernel(shape, dtype, tol):
    rng = np.random.default_rng(shape[-1] + 1)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    m = _mask(shape, rng)
    (jx, tx), (jm, tm) = _pair(x, dtype), _pair(m)
    want = np.asarray(ref_softmax.softmax(jx, 0.25, jm), np.float32)
    assert np.isfinite(want).all()
    assert (want.reshape(-1, shape[-1])[2] == 0).all()
    for got in (softmax.softmax_masked_plain(tx.reshape(-1, shape[-1]),
                                             tm.reshape(-1, shape[-1]),
                                             0.25).reshape(shape),
                softmax.softmax(tx, 0.25, tm)):
        assert got.shape == tx.shape and got.dtype == tx.dtype
        _close(got, want, tol)
        assert (got.reshape(-1, shape[-1])[2] == 0).all()
        assert (got[~tm] == 0).all()


@pytest.mark.parametrize("block", [512, 2048, 4096])
@pytest.mark.parametrize("dtype,tol", SOFTMAX_DTYPES)
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("rows,d", [(3, 10001), (4, 8193), (2, 5000)],
                         ids=["3x10001", "4x8193", "2x5000"])
def test_softmax_split_matches_reference_kernel(rows, d, masked, dtype, tol,
                                                block):
    """The split layout's algorithm (chunk partials, their fold, the
    write) at ragged widths and several chunk widths against the
    reference's Pallas kernels (interpret mode): a row of -inf and a row
    holding a NaN stay NaN unmasked; masked, a fully masked row is 0 and a
    row masked in its first half (its first chunks all -inf) is finite."""
    rng = np.random.default_rng(d + block)
    x = (3.0 * rng.standard_normal((rows, d))).astype(np.float32)
    m = None
    if masked:
        m = rng.random((rows, d)) < 0.6
        m[0] = False
        m[1, : d // 2] = False
    else:
        x[1] = -np.inf
        x[-1, d // 3] = np.nan
    jx, tx = _pair(x, dtype)
    if masked:
        jm, tm = _pair(m)
        want = np.asarray(ref_softmax.softmax(jx, 0.7, jm), np.float32)
        got = softmax.softmax_split_plain(tx, 0.7, tm, block=block)
        assert (got[0] == 0).all() and (got[~tm] == 0).all()
        assert torch.isfinite(got).all()
    else:
        want = np.asarray(ref_softmax.softmax(jx, 0.7), np.float32)
        got = softmax.softmax_split_plain(tx, 0.7, block=block)
        assert np.isnan(want[1]).all() and torch.isnan(got[1]).all()
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(torch.isnan(got).numpy(), np.isnan(want))
    _close(torch.nan_to_num(got), np.nan_to_num(want), tol)


def test_softmax_split_plan():
    """Rows up to the one-pass block are taken whole; wider rows split
    into ``SPLIT_BLOCK`` columns a program: 75 chunks of a 151936 row."""
    assert softmax.split_plan(softmax.MAX_ONE_PASS) is None
    assert softmax.split_plan(333) is None
    assert softmax.split_plan(151936) == (softmax.SPLIT_BLOCK, 75)
    assert softmax.split_plan(softmax.MAX_ONE_PASS + 1) == (
        softmax.SPLIT_BLOCK, -(-(softmax.MAX_ONE_PASS + 1)
                                // softmax.SPLIT_BLOCK))


def test_softmax_masked_broadcasts_the_mask():
    """A (B, 1, L, L) mask against (B, H, L, L) scores, as the reference
    wrapper broadcasts it; fully masked query rows give 0."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    m = padding_mask(LENS, 8).numpy()
    (jx, tx), (jm, tm) = _pair(x), _pair(m)
    want = ref_softmax.softmax(jx, 0.3, jm)
    got = softmax.softmax(tx, 0.3, tm)
    _close(got, want, (2e-5, 2e-6))
    assert (got[1, :, 5:] == 0).all()


def test_unmasked_softmax_keeps_nan_on_a_row_of_minus_inf():
    x = np.random.default_rng(2).standard_normal((3, 40)).astype(np.float32)
    x[1] = -np.inf
    jx, tx = _pair(x)
    want = np.asarray(ref_softmax.softmax(jx, 1.0))
    assert np.isnan(want[1]).all() and np.isfinite(want[[0, 2]]).all()
    for got in (softmax.softmax_plain(tx, 1.0), softmax.softmax(tx, 1.0)):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,V", [(16, 2500), (33, 1000), (8, 4096)])
def test_cross_entropy_plain_matches_reference_kernel(B, V, dtype, tol):
    rng = np.random.default_rng(V)
    x = (4.0 * rng.standard_normal((B, V))).astype(np.float32)
    lab = rng.integers(0, V, B).astype(np.int32)
    (jx, tx), (jl, tl) = _pair(x, dtype), _pair(lab)
    want = float(ref_xent.cross_entropy(jx, jl))
    lf = jx.astype(jnp.float32)
    rows = np.asarray(jax.nn.logsumexp(lf, axis=-1)
                      - jnp.take_along_axis(lf, jl[:, None], axis=-1)[:, 0])
    got_rows = cross_entropy.cross_entropy_plain(tx, tl)
    assert got_rows.shape == (B,) and got_rows.dtype == torch.float32
    np.testing.assert_allclose(got_rows.numpy(), rows, rtol=1e-5, atol=1e-5)
    for got in (cross_entropy.cross_entropy(tx, tl), ref.cross_entropy(tx, tl)):
        assert got.shape == () and got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-5)


# -- the ref oracles --------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_ref_oracles_match_the_reference_oracles(dtype, tol):
    rng = np.random.default_rng(11)
    x, r = (rng.standard_normal((5, 96)).astype(np.float32) for _ in range(2))
    g = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    (jx, tx), (jr, tr), (jg, tg) = (_pair(a, dtype) for a in (x, r, g))
    for a, b in zip(ref.rmsnorm_residual(tx, tr, tg),
                    ref_oracles.rmsnorm_residual(jx, jr, jg)):
        _close(a, b, tol)
    m = _mask((5, 96), rng)
    jm, tm = _pair(m)
    for mask in (None, (jm, tm)):
        want = np.asarray(ref_oracles.softmax(jx, 0.5, None if mask is None
                                              else mask[0]), np.float32)
        got = ref.softmax(tx, 0.5, None if mask is None else mask[1])
        # the fully masked row is NaN in both oracles
        assert np.isnan(want[2]).all() == (mask is not None)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol, equal_nan=True)
    lab = np.array([0, 95, 17, 3, 50], np.int32)
    jl, tl = _pair(lab)
    np.testing.assert_allclose(float(ref.cross_entropy(tx, tl)),
                               float(ref_oracles.cross_entropy(jx, jl)),
                               rtol=1e-5)


def test_ref_cross_entropy_wraps_negative_labels():
    """``jnp.take_along_axis`` reads label -1 as the last column."""
    x = np.random.default_rng(3).standard_normal((4, 30)).astype(np.float32)
    lab = np.array([-1, 29, -30, 0], np.int32)
    (jx, tx), (jl, tl) = _pair(x), _pair(lab)
    np.testing.assert_allclose(float(ref.cross_entropy(tx, tl)),
                               float(ref_oracles.cross_entropy(jx, jl)),
                               rtol=1e-6)


# -- the three path functions -----------------------------------------------------------

def _ref_fns():
    """Fresh reference path functions (the reference's trace caches key on
    the function object, not on the kernel mode)."""
    def seam(x, res, gamma, w_out, labels):
        h, new_res = ref_ops.rmsnorm_residual(x, res, gamma, 1e-6)
        logits = h.reshape(-1, h.shape[-1]) @ w_out
        return ref_ops.cross_entropy(logits, labels), new_res

    def attn(q, k, v, mask):
        group = q.shape[2] // k.shape[2]
        kr, vr = jnp.repeat(k, group, axis=2), jnp.repeat(v, group, axis=2)
        s = jnp.einsum("bqhd,bkhd->bhqk", q, kr)
        p = ref_ops.softmax(s, q.shape[-1] ** -0.5, mask)
        return jnp.einsum("bhqk,bkhd->bqhd", p, vr)

    def probs(logits):
        return ref_ops.softmax(logits, 1 / 0.7)

    return {"seam": seam, "attn": attn, "probs": probs}


PORT_FNS = {"seam": seam_loss, "attn": masked_attention, "probs": vocab_probs}
PATHS = ["seam", "attn", "probs"]
MODES = [("pallas", "kernels"), ("ref", "ref")]


@functools.lru_cache(maxsize=None)
def path_inputs(path: str) -> tuple:
    """numpy inputs of one path function at the tests' small sizes."""
    rng = np.random.default_rng(len(path))
    f32 = np.float32
    if path == "seam":
        return (rng.standard_normal((2, 8, D)).astype(f32),
                rng.standard_normal((2, 8, D)).astype(f32),
                (1 + 0.1 * rng.standard_normal(D)).astype(f32),
                (rng.standard_normal((D, V)) / np.sqrt(D)).astype(f32),
                rng.integers(0, V, T).astype(np.int32))
    if path == "attn":
        # (2, 2, 8, 8) scores: 2 q heads on 1 kv head, head width 16
        return (rng.standard_normal((2, 8, 2, 16)).astype(f32),
                rng.standard_normal((2, 8, 1, 16)).astype(f32),
                rng.standard_normal((2, 8, 1, 16)).astype(f32),
                padding_mask(LENS, 8).numpy())
    return ((2.0 * rng.standard_normal((4, V))).astype(f32),)


@functools.lru_cache(maxsize=None)
def traced(path: str, modes: tuple):
    """(reference graph with its Pallas nodes tagged, port graph)."""
    args = path_inputs(path)
    with ref_ops.kernel_mode(modes[0]):
        rg, _ = ref_trace(_ref_fns()[path], *(jnp.asarray(a) for a in args),
                          name=path)
    for n in rg.nodes.values():
        name = ref_kernel_name(n) if "project" not in n.attrs else None
        if name is not None:
            n.attrs["kernel"] = name
    for n in rg.nodes.values():
        if "project" in n.attrs and "kernel" in rg[n.operands[0]].attrs:
            n.attrs["kernel"] = rg[n.operands[0]].attrs["kernel"]
    with ops.kernel_mode(modes[1]):
        g, _ = trace_to_graph(PORT_FNS[path], *(torch.as_tensor(a) for a in args),
                              name=path)
    return rg, g


def _kernel_nodes(graph):
    """Each kernel-tagged node (projections too): (tag, projection, shape,
    dtype, operands' (kind, shape, dtype)), sorted."""
    out = []
    for n in graph.nodes.values():
        if n.attrs.get("kernel") is None:
            continue
        out.append((n.attrs["kernel"], n.attrs.get("project"), tuple(n.shape),
                    str(n.dtype), tuple((graph[o].kind.value, tuple(graph[o].shape),
                                         str(graph[o].dtype))
                                        for o in n.operands)))
    return sorted(out, key=repr)


KERNEL_NODES = {
    "seam": {"_rmsnorm_residual_kernel": 3, "_xent_kernel": 1},
    "attn": {"_softmax_masked_kernel": 1},
    "probs": {"_softmax_kernel": 1},
}


@pytest.mark.parametrize("path", PATHS)
def test_traced_kernel_nodes_match_the_reference(path):
    rg, g = traced(path, ("pallas", "kernels"))
    port = _kernel_nodes(g)
    assert port == _kernel_nodes(rg)
    counts = {}
    for tag, *_ in port:
        counts[tag] = counts.get(tag, 0) + 1
    assert counts == KERNEL_NODES[path]
    assert all(n.kind is OpKind.CUSTOM for n in g.nodes.values()
               if n.attrs.get("kernel"))
    if path == "attn":
        # the mask: broadcast to the scores' shape, then (rows, d)
        (node,) = [n for n in g.nodes.values() if n.attrs.get("kernel")]
        chain = []
        m = g[node.operands[1]]
        while m.kind is not OpKind.PARAMETER:
            chain.append((m.kind, tuple(m.shape), str(m.dtype)))
            m = g[m.operands[0]]
        assert chain == [(OpKind.RESHAPE, (32, 8), "bool"),
                         (OpKind.BROADCAST, (2, 2, 8, 8), "bool")]


def test_ref_mode_gather_is_spelled_as_the_reference():
    """``take_along_axis``'s steps on ``labels[:, None]``: the labels taken
    to a (T, 1) index first (jax's expand_dims is a broadcast, torch's a
    reshape), then the index wrap (lt, add, select) at (T, 1), one CUSTOM
    gather (the reference's through a (T, 1, 1) reshape of the index), the
    ``[..., 0]`` slice."""
    rg, g = traced("seam", ("ref", "ref"))
    for graph, prim in ((g, "aten.gather.default"), (rg, "gather")):
        (gather,) = [n for n in graph.nodes.values()
                     if n.attrs.get("prim") == prim]
        sel = graph[gather.operands[1]]
        if sel.kind.value == "reshape":
            sel = graph[sel.operands[0]]
        assert sel.attrs.get("op") == "select" and tuple(sel.shape) == (T, 1)
        wrap = [graph[o] for o in sel.operands[:2]]
        assert sorted(n.attrs.get("op") for n in wrap) == ["add", "lt"]
        for n in wrap:
            assert tuple(n.shape) == (T, 1)
            idx = graph[n.operands[0]]
            assert idx.kind.value in ("reshape", "broadcast")
            assert tuple(idx.shape) == (T, 1) and str(idx.dtype) == "int32"
        (user,) = graph.users(gather.name)
        assert graph[user].kind.value == "slice"
        assert tuple(gather.shape) == (T, 1)


# member-set sizes of the reference graph's plans at T=16, D=64, V=2500:
# pallas mode {rmsnorm_residual node, its projections, the reshapes, the
# GEMM}, {the mean's reduce_sum and div}, {the xent node}; ref mode the
# norm, GEMM and index wrap, the logsumexp and the mean, the gather alone
PLANS = {("seam", "pallas"): (12, [1, 2, 9]), ("seam", "ref"): (32, [1, 14, 17])}


@pytest.mark.parametrize("modes", MODES, ids=["kernel_mode", "ref_mode"])
@pytest.mark.parametrize("path", PATHS)
def test_reference_graph_plans_equal_in_both_planners(path, modes):
    rg, _ = traced(path, modes)
    ref_plan = RefCompiler(REF_V100, mode="stitch", use_pallas=False).compile(rg)
    port = StitchCompiler(V100, mode="stitch").compile(to_port(rg))
    assert port.stats.n_ops == ref_plan.stats.n_ops
    assert port.stats.n_kernels == ref_plan.stats.n_kernels
    assert _groups(port) == _groups(ref_plan)
    assert port.stats.pattern_classes == ref_plan.stats.pattern_classes
    if (path, modes[0]) in PLANS:
        n_ops, sizes = PLANS[path, modes[0]]
        assert port.stats.n_ops == n_ops and port.stats.n_kernels == 3
        assert sorted(len(grp.members) for grp in port.groups) == sizes
    # the unregistered softmax and xent nodes cut the graph: each alone
    for grp in port.groups:
        tags = {port.graph[m].attrs.get("kernel") for m in grp.members}
        if tags & {"_softmax_kernel", "_softmax_masked_kernel", "_xent_kernel"}:
            assert len(grp.members) == 1


def test_port_kernel_mode_seam_plans_as_the_reference():
    """The port's own kernel-mode graph of the seam is the reference's node
    for node (up to the CUSTOM nodes' names), so its plan is too."""
    rg, g = traced("seam", ("pallas", "kernels"))
    ref_plan = RefCompiler(REF_V100, mode="stitch", use_pallas=False).compile(rg)
    port = StitchCompiler(V100, mode="stitch").compile(g)
    assert (port.stats.n_ops, port.stats.n_kernels) == (12, 3)
    renamed = [(sorted(m.replace("custom_pallas_call_", "custom_")
                       for m in members), packed)
               for members, packed in _groups(ref_plan)]
    assert _groups(port) == sorted(renamed)


def test_port_ref_mode_seam_plans_to_three_kernels():
    """The port's own ref-mode graph: 32 ops, as the reference's (the
    RMSNorm mean and the loss's mean each a sum, a broadcast where dims are
    kept and a division; the labels taken to a (B, 1) index before the
    wrap), planned as the reference's: the gather alone, the logsumexp with
    the mean."""
    _, g = traced("seam", ("ref", "ref"))
    port = StitchCompiler(V100, mode="stitch").compile(g)
    assert (port.stats.n_ops, port.stats.n_kernels) == (32, 3)
    assert sorted(len(grp.members) for grp in port.groups) == [1, 14, 17]
    (alone,) = [grp for grp in port.groups if len(grp.members) == 1]
    (name,) = alone.members
    assert g[name].attrs.get("prim") == "aten.gather.default"


@functools.lru_cache(maxsize=None)
def stitched_run(path: str, modes: tuple):
    """(reference ``jax.jit`` outputs, port ``stitch()`` outputs on the
    CPU, the port's stitched function), as numpy."""
    args = path_inputs(path)
    with ref_ops.kernel_mode(modes[0]):
        want = jax.jit(_ref_fns()[path])(*(jnp.asarray(a) for a in args))
    with ops.kernel_mode(modes[1]):
        sf = stitch(PORT_FNS[path], device="cpu")
        got = sf(*(torch.as_tensor(a) for a in args))
    flat = (lambda o: o if isinstance(o, tuple) else (o,))
    return ([np.asarray(w) for w in flat(want)],
            [o.numpy() for o in flat(got)], sf)


@pytest.mark.parametrize("modes", MODES, ids=["kernel_mode", "ref_mode"])
@pytest.mark.parametrize("path", PATHS)
def test_stitched_path_matches_reference_jit(path, modes):
    want, got, sf = stitched_run(path, modes)
    assert sf.report()["calls"]["stitched"] == 1
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, **TOL)
    if path == "attn":
        # query rows past each length are fully masked: 0 through the
        # kernel, NaN through the ref oracle, in both packages
        rows = got[0][1, 5:]
        if modes[1] == "kernels":
            assert (rows == 0).all() and (want[0][1, 5:] == 0).all()
            assert np.isfinite(got[0]).all()
        else:
            assert np.isnan(rows).all() and np.isnan(want[0][1, 5:]).all()
            assert np.isfinite(got[0][:, :5]).all()
    tags = {n.attrs.get("kernel") for n in sf.compiled.graph.nodes.values()}
    assert (tags - {None} == set(KERNEL_NODES[path])) == (modes[1] == "kernels")

