"""The port's ssm family (falcon-mamba-7b, reduced) against the reference.

* The selective scan's plain version (what the CUDA kernel computes)
  against the reference's Pallas ``_mamba_kernel`` (interpret mode) at the
  reference's own sweep shapes, f32 within 2e-4 (the reference's own
  tolerance) and bf16 x/delta within 1.6e-2 (one bf16 rounding of y, which
  both sides take once from f32); B and C also as strided column views, as
  the model hands them.  The port's oracle with its final state against the
  reference's oracle.
* The ref-mode oracle traces to one untagged CUSTOM node, as the
  reference's ``lax.scan`` is one node; the kernel op traces to one node
  tagged ``_mamba_kernel``, which the registry does not know (nor does the
  reference's), so the planner cuts the graph there.
* ``_causal_conv``, the reduced ``block_fn`` (f32, kernel mode) and the
  reduced ``train_forward`` loss (both modes) against the reference's, with
  the same weights (``params_from_jax``).
* ``stitch(train_forward)`` in kernel mode on the CPU against eager, with
  one scan node a layer and one RMSNorm node a layer plus the final one,
  each scan alone in its group.
* A ``GraphBuilder`` graph with an elementwise halo around an unregistered
  scan node plans identically in both packages, and the traced reduced
  ``block_fn`` holds one scan node with the reference's operands in both.
* ssm serving is not ported: ``Engine`` and the launcher refuse it.

The two frontends spell some ops differently around the scan: the
reference traces ``jnp.split`` to one CUSTOM ``split`` node with two
projections where the port slices twice; the reference's ``ne`` is one
CUSTOM node where the port has ``eq`` and ``not``; the reference broadcasts
a zeros literal to the full shape before adding the conv bias where the
port adds a scalar; the reference keeps 3-D dots where the port reshapes
to 2-D around them.  Both pad with one CUSTOM node.  So the tests compare
the scan node's operands and the planning around it, not node for node.
"""

from __future__ import annotations

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_reduced as ref_reduced
from repro.core import StitchCompiler as RefCompiler
from repro.core import V100 as REF_V100
from repro.core import GraphBuilder as RefBuilder
from repro.core.trace import trace_to_graph as ref_trace
from repro.kernels import mamba_scan as ref_mamba
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.models import build_model as ref_build
from repro.models import mamba as ref_mamba_model
from repro.models.config import SSMConfig as RefSSMConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import OpKind, StitchCompiler, V100
from repro_torch.core.trace import trace_to_graph
from repro_torch.exec import stitch
from repro_torch.kernels import mamba_scan, ops, ref, registry
from repro_torch.models import build_model, mamba
from repro_torch.models.config import SSMConfig
from repro_torch.models.convert import params_from_jax, params_to_numpy

from test_torch_kernel_mode import ref_kernel_name
from test_torch_planner import _groups, to_port

ARCH = "falcon-mamba-7b"
TOL = dict(rtol=2e-4, atol=2e-4)
DTYPES = [("float32", 2e-4), ("bfloat16", 1.6e-2)]
# the reduced loss, port against reference, same mode pairs: readings 0 (ref
# mode) and 4.8e-7 (kernel vs pallas) on a loss of 6.06; the reference holds
# its own two modes within 5e-3
LOSS_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def setup():
    rcfg = replace(ref_reduced(ARCH), dtype="float32", scan_layers=False,
                   remat="none")
    cfg = replace(get_reduced(ARCH), dtype="float32", scan_layers=False,
                  remat="none")
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, rparams)
    model = build_model(cfg)
    params = params_from_jax(tree, cfg, device="cpu")
    return rmodel, rparams, tree, model, params


def _batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S))
    labels = rng.integers(0, cfg.vocab, (B, S))
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)})


def _x(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _scan_inputs(Bb, L, Dm, N, seed=0, stride_bc=False):
    """The reference sweep's distributions (x at 0.5, delta |0.1 normal|,
    A = -|normal|, B and C at 0.3); with ``stride_bc`` B and C are column
    views of one (Bb, L, 4 + 2N) array, as the model's ``dbc`` hands them."""
    rng = np.random.default_rng(seed)
    x = _x(rng, (Bb, L, Dm), 0.5)
    dt = np.abs(_x(rng, (Bb, L, Dm), 0.1))
    A = -np.abs(_x(rng, (Dm, N)))
    dbc = _x(rng, (Bb, L, 4 + 2 * N), 0.3)
    B, C = dbc[..., 4:4 + N], dbc[..., 4 + N:]
    D = _x(rng, (Dm,))
    port = [torch.as_tensor(a) for a in (x, dt, A, dbc, D)]
    tB, tC = port[3][..., 4:4 + N], port[3][..., 4 + N:]
    if not stride_bc:
        tB, tC = tB.contiguous(), tC.contiguous()
    return ((x, dt, A, np.ascontiguousarray(B), np.ascontiguousarray(C), D),
            (port[0], port[1], port[2], tB, tC, port[4]))


SWEEP = [(1, 16, 32, 8), (2, 48, 64, 16), (2, 33, 128, 16)]


# -- the scan --------------------------------------------------------------------

@pytest.mark.parametrize("stride_bc", [False, True], ids=["contiguous_bc",
                                                          "strided_bc"])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("Bb,L,Dm,N", SWEEP)
def test_scan_plain_matches_reference_kernel(Bb, L, Dm, N, dtype, tol,
                                             stride_bc):
    (x, dt, A, B, C, D), (tx, tdt, tA, tB, tC, tD) = _scan_inputs(
        Bb, L, Dm, N, seed=L + Dm, stride_bc=stride_bc)
    assert tB.is_contiguous() != stride_bc
    jd = getattr(jnp, dtype)
    want = ref_mamba.mamba_scan(jnp.asarray(x, jd), jnp.asarray(dt, jd),
                                A, B, C, D)
    td = getattr(torch, dtype)
    for fn in (mamba_scan.mamba_scan, mamba_scan.mamba_scan_plain,
               ref.mamba_scan):
        got = fn(tx.to(td), tdt.to(td), tA, tB, tC, tD)
        assert got.dtype == td and got.shape == tx.shape
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("Bb,L,Dm,N", SWEEP)
def test_scan_lane_order_matches_reference_kernel(Bb, L, Dm, N, dtype, tol):
    """The lanes kernel's arithmetic spelled in PyTorch (the states added
    one at a time in increasing n, as the lanes kernel hands the sum from
    lane to lane) against the Pallas scan (interpret mode), B and C as
    strided views."""
    (x, dt, A, B, C, D), (tx, tdt, tA, tB, tC, tD) = _scan_inputs(
        Bb, L, Dm, N, seed=L + Dm, stride_bc=True)
    jd = getattr(jnp, dtype)
    want = ref_mamba.mamba_scan(jnp.asarray(x, jd), jnp.asarray(dt, jd),
                                A, B, C, D)
    td = getattr(torch, dtype)
    got = mamba_scan.mamba_scan_lanes_plain(tx.to(td), tdt.to(td), tA, tB, tC,
                                            tD)
    assert got.dtype == td and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_ref_scan_with_state_matches_reference_oracle(dtype, tol):
    (x, dt, A, B, C, D), (tx, tdt, tA, tB, tC, tD) = _scan_inputs(
        2, 24, 48, 16, seed=3, stride_bc=True)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ry, rh = ref_oracles.mamba_scan(jnp.asarray(x, jd), jnp.asarray(dt, jd),
                                    A, B, C, D, return_state=True)
    y, h = ref.mamba_scan(tx.to(td), tdt.to(td), tA, tB, tC, tD,
                          return_state=True)
    assert y.dtype == td and h.dtype == torch.float32
    assert tuple(h.shape) == (2, 48, 16)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ry, np.float32),
                               rtol=tol, atol=tol)
    # the state is f32 on both sides, from the same (rounded) inputs
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), **TOL)
    # and the y without the state is the same y
    torch.testing.assert_close(ref.mamba_scan(tx.to(td), tdt.to(td), tA, tB,
                                              tC, tD), y, rtol=0, atol=0)


def _scan_nodes(g):
    return [n for n in g.nodes.values() if n.kind is OpKind.CUSTOM
            and "mamba_scan" in str(n.attrs.get("prim"))]


@pytest.mark.parametrize("return_state", [False, True])
def test_ref_scan_traces_to_one_untagged_custom_node(return_state):
    _, (tx, tdt, tA, tB, tC, tD) = _scan_inputs(2, 40, 16, 8)
    g, _ = trace_to_graph(lambda *a: ref.mamba_scan(*a, return_state=return_state),
                          tx, tdt, tA, tB, tC, tD)
    (node,) = [n for n in _scan_nodes(g) if "project" not in n.attrs]
    assert "kernel" not in node.attrs
    assert node.attrs["prim"] == ("repro_torch.mamba_scan_ref_state.default"
                                  if return_state
                                  else "repro_torch.mamba_scan_ref.default")
    # no step of the loop reaches the graph
    assert not [n for n in g.nodes.values()
                if n.kind is not OpKind.PARAMETER and n not in _scan_nodes(g)]
    assert registry.lookup(node) is None


def test_kernel_op_traces_to_one_unregistered_tagged_node():
    _, args = _scan_inputs(2, 40, 16, 8, stride_bc=True)
    with ops.kernel_mode("kernels"):
        g, _ = trace_to_graph(ops.mamba_scan, *args)
    (node,) = _scan_nodes(g)
    assert node.attrs["kernel"] == "_mamba_kernel"
    assert node.attrs["prim"] == "repro_torch.mamba_scan.default"
    assert registry.lookup(node) is None
    assert "_mamba_kernel" not in registry._REGISTRY
    # asking for the state runs the oracle, as in the reference
    with ops.kernel_mode("kernels"):
        g, _ = trace_to_graph(lambda *a: ops.mamba_scan(*a, return_state=True),
                              *args)
    assert all("kernel" not in n.attrs for n in _scan_nodes(g))


# -- config, params --------------------------------------------------------------

def test_falcon_mamba_config_equals_the_reference():
    for port_cfg, rcfg in ((get_config(ARCH), ref_config(ARCH)),
                           (get_reduced(ARCH), ref_reduced(ARCH))):
        assert vars(port_cfg.ssm) == vars(rcfg.ssm)
        assert {k: v for k, v in vars(port_cfg).items() if k != "ssm"} == \
            {k: v for k, v in vars(rcfg).items() if k != "ssm"}
    assert [f.name for f in SSMConfig.__dataclass_fields__.values()] == \
        [f.name for f in RefSSMConfig.__dataclass_fields__.values()]


def test_ssm_params_round_trip_and_count():
    _, _, tree, model, params = setup()
    cfg = model.cfg
    s, dm, dtr = mamba._dims(cfg)
    lp = model.layer_params(params, 1)
    assert set(lp) == {"norm", "in_proj", "conv_w", "conv_b", "x_proj",
                       "dt_proj", "dt_bias", "A_log", "D", "out_proj"}
    assert tuple(lp["x_proj"].shape) == (dm, dtr + 2 * s.d_state)
    back = params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    # ModelConfig.param_count (a verbatim copy of the reference's) leaves
    # out the ssm conv bias, dm a layer: 8,192 a layer at full width.  The
    # copy keeps the omission; the measured count says it.
    own = build_model(cfg).init(0, "cpu")
    measured = sum(a.size for a in jax.tree_util.tree_leaves(
        params_to_numpy(own)))
    assert measured == cfg.param_count() + cfg.n_layers * dm


# -- the model against the reference ----------------------------------------------

@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_causal_conv_matches_reference(dtype, tol):
    rng = np.random.default_rng(7)
    x, w, b = _x(rng, (2, 11, 24)), _x(rng, (4, 24)), _x(rng, (24,))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_mamba_model._causal_conv(jnp.asarray(x, jd), jnp.asarray(w),
                                        jnp.asarray(b))
    got = mamba._causal_conv(torch.as_tensor(x).to(td), torch.as_tensor(w),
                             torch.as_tensor(b))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_softplus_matches_reference():
    x = np.array([-30.0, -3.0, -0.5, 0.0, 0.25, 4.0, 25.0, np.nan, np.inf,
                  -np.inf], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = mamba._softplus(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _block_inputs(model, rparams, params, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (2, 32, model.cfg.d_model)).astype(np.float32)
    rlp = jax.tree.map(lambda a: a[0], rparams["layers"])
    return rlp, jnp.asarray(x), model.layer_params(params, 0), torch.as_tensor(x)


def test_block_fn_kernel_mode_matches_reference_pallas():
    rmodel, rparams, _, model, params = setup()
    rlp, rx, lp, x = _block_inputs(model, rparams, params)
    with ref_ops.kernel_mode("pallas"):
        want = jax.jit(lambda p, v: rmodel.block_fn(p, v))(rlp, rx)
    with ops.kernel_mode("kernels"):
        got = model.block_fn(lp, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("modes", [("ref", "ref"), ("pallas", "kernels")],
                         ids=["ref_mode", "kernel_mode"])
def test_train_forward_loss_matches_reference(modes):
    rmodel, rparams, _, model, params = setup()
    rbatch, batch = _batch(model.cfg)
    with ref_ops.kernel_mode(modes[0]):
        want, _ = rmodel.train_forward(rparams, rbatch)
    with ops.kernel_mode(modes[1]):
        got, aux = model.train_forward(params, batch)
    assert aux == {} and got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) < LOSS_TOL


def test_stitched_train_forward_kernel_mode_matches_eager():
    _, _, _, model, params = setup()
    _, batch = _batch(model.cfg, seed=2)
    L = model.cfg.n_layers
    with ops.kernel_mode("kernels"):
        eager, _ = model.train_forward(params, batch)
        sf = stitch(model.train_forward, device="cpu")
        got, _ = sf(params, batch)
    assert sf.report()["calls"]["stitched"] == 1
    assert abs(float(got) - float(eager)) < LOSS_TOL
    g = sf.graph
    tags = [n.attrs.get("kernel") for n in g.nodes.values()]
    assert tags.count("_mamba_kernel") == L
    assert tags.count("_rmsnorm_kernel") == L + 1
    # each scan is a group of its own: the planner cuts the graph there
    for grp in sf.compiled.groups:
        if any(g[m].attrs.get("kernel") == "_mamba_kernel" for m in grp.members):
            assert len(grp.members) == 1 and grp.kind == "op"


# -- planning around the scan -----------------------------------------------------

def _scan_halo_graph(builder):
    """An elementwise halo around one scan node: softplus on delta, the
    scan (a CUSTOM node tagged ``_mamba_kernel``), a SiLU gate on its
    output, spelled as the reference's jaxpr spells them."""
    Bb, L, Dm, N = 2, 32, 64, 8
    b = builder("scan_halo")
    x, pre = b.param("x", (Bb, L, Dm)), b.param("pre", (Bb, L, Dm))
    z = b.param("z", (Bb, L, Dm))
    A, Bm = b.param("A", (Dm, N)), b.param("B", (Bb, L, N))
    Cm, D = b.param("C", (Bb, L, N)), b.param("D", (Dm,))
    zero = b.const("zero")
    mx = b.ew("max", pre, zero)
    sub = b.ew("sub", pre, zero)
    soft = b.ew("add", mx, b.ew("log1p", b.ew("exp", b.ew("neg", b.ew("abs", sub)))))
    scan = b.custom("_mamba_kernel", (Bb, L, Dm), "float32",
                    (x, soft, A, Bm, Cm, D), kernel="_mamba_kernel")
    gate = b.ew("mul", z, b.ew("sigmoid", z))
    return b.build(outputs=[b.ew("mul", scan, gate)])


@pytest.mark.parametrize("mode", ["stitch", "xla"])
def test_scan_halo_plan_equals_reference(mode):
    rg = _scan_halo_graph(RefBuilder)
    ref_plan = RefCompiler(REF_V100, mode=mode, use_pallas=False).compile(rg)
    port = StitchCompiler(V100, mode=mode).compile(to_port(rg))
    assert port.stats.n_ops == ref_plan.stats.n_ops
    assert port.stats.n_kernels == ref_plan.stats.n_kernels
    assert _groups(port) == _groups(ref_plan)
    scan = [grp for grp in port.groups
            if any(port.graph[m].attrs.get("kernel") == "_mamba_kernel"
                   for m in grp.members)]
    assert len(scan) == 1 and len(scan[0].members) == 1
    if mode == "stitch":
        # the halo on each side is stitched, not left as single ops
        assert any(len(grp.members) > 1 for grp in port.groups)


def test_traced_block_scan_node_matches_the_reference():
    rmodel, rparams, _, model, params = setup()
    rlp, rx, lp, x = _block_inputs(model, rparams, params)
    with ref_ops.kernel_mode("pallas"):
        rg, _ = ref_trace(lambda p, v: rmodel.block_fn(p, v), rlp, rx,
                          name="block")
    with ops.kernel_mode("kernels"):
        g, _ = trace_to_graph(lambda p, v: model.block_fn(p, v), lp, x,
                              name="block")
    (rnode,) = [n for n in rg.nodes.values()
                if ref_kernel_name(n) == "_mamba_kernel"]
    (node,) = _scan_nodes(g)
    assert node.attrs["kernel"] == "_mamba_kernel"
    spell = lambda graph, n: (tuple(n.shape), str(n.dtype))
    assert spell(g, node) == spell(rg, rnode)
    assert [spell(g, g[o]) for o in node.operands] == \
        [spell(rg, rg[o]) for o in rnode.operands]
    rplan = RefCompiler(REF_V100, mode="stitch", use_pallas=False).compile(rg)
    plan = StitchCompiler(V100, mode="stitch").compile(g)
    for compiled, name in ((rplan, rnode.name), (plan, node.name)):
        (grp,) = [grp for grp in compiled.groups if name in grp.members]
        assert list(grp.members) == [name]


# -- serving is not ported --------------------------------------------------------

def test_ssm_serving_is_refused():
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import Engine, ServeConfig
    _, _, _, model, params = setup()
    assert model.prefill is None and model.decode_step is None
    with pytest.raises(NotImplementedError, match="ssm serving is not ported"):
        Engine(model, params, ServeConfig(batch=2, max_len=16), device="cpu")
    with pytest.raises(NotImplementedError, match="ssm serving is not ported"):
        launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
