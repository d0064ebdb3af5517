"""The Normal log-density kernel of data shared by the chains
(``ops.kernels.normal_plane``, ``csrc/normal_plane.cu``).

``Normal(loc, scale).log_prob(value)`` takes it when ``value`` is data (a
plain tensor no ``torch.func`` transform wraps) and loc and scale are 0-d
per chain; every other call keeps the plain expression, op for op. On the
CPU the Function runs its plain version, so these tests hold the routing
rule, the Function's derivatives (reverse, forward, second order, under
``vmap``) against the expression it replaces, and the kernel's layout
arithmetic through a mirror. On the card (marked ``gpu``; the file imports
no JAX, so it runs past the suite's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_normal_plane.py

the kernels against the plain version at the SMC cell's (131,072, 1,000),
at ragged sizes and from a strided cotangent, and a routed model's captured
HMC transition against the eager one, bitwise.
"""

import math

import numpy as np
import pytest
import torch
from torch.func import grad, grad_and_value, hessian, vmap
from torch.utils._python_dispatch import TorchDispatchMode

import fugue_tpu_torch as ftt
from fugue_tpu_torch import settings
from fugue_tpu_torch.dsl.compiler import compile_model
from fugue_tpu_torch.inference import hmc
from fugue_tpu_torch.ops import kernels as K
from fugue_tpu_torch.utils import profiling
from perfbench import harness

GMM = harness.config("gmm_mixture")


@pytest.fixture
def x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


def _plain(monkeypatch):
    """Every Normal.log_prob takes the plain expression."""
    monkeypatch.setattr(K, "normal_plane_routes", lambda value, loc, scale: False)


def _gmm(device="cpu", dtype=torch.float64, n=GMM.N):
    return ftt.stage(GMM.build(0, device, n=n, dtype=dtype).model_fn, device=device)


def _gmm_points(c, seed=1, device="cpu", dtype=torch.float64):
    rng = np.random.default_rng(seed)
    q = rng.normal([-2.7, 1.7, 0.0, 0.0, 0.3], [0.6, 0.5, 0.5, 0.5, 1.0], (c, 5))
    return torch.as_tensor(q, dtype=dtype, device=device)


# -- the routing rule --------------------------------------------------------

Y = torch.linspace(-3.0, 3.0, 7, dtype=torch.float64)
Y2 = Y.reshape(7, 1).expand(7, 2)
Y_LEAF = Y.clone().requires_grad_(True)


def _seen_under_vmap(make_args):
    """The routing decision for ``make_args(z)``'s (value, loc, scale) inside
    ``vmap(grad(...))`` over 3 chains of z (2,)."""
    seen = []

    def f(z):
        args = make_args(z)
        seen.append(K.normal_plane_routes(*args))
        return torch.sum(ftt.Normal(args[1], args[2]).log_prob(args[0]))

    vmap(grad(f))(torch.tensor([[0.1, 0.2], [0.3, 0.4], [0.5, 0.6]], dtype=torch.float64))
    return seen[0]


ROUTING = {
    "data, per-chain loc and scale": (lambda z: (Y, z[0], torch.exp(z[1])), True),
    "data, per-chain loc, fixed scale": (lambda z: (Y, z[0], torch.tensor(2.0, dtype=Y.dtype)),
                                         True),
    "2-d data": (lambda z: (Y2, z[0], torch.exp(z[1])), True),
    # an op inside a torch.func transform wraps its result, data or not
    "data reshaped inside the transform": (lambda z: (Y.reshape(7, 1), z[0], torch.exp(z[1])),
                                           False, True),
    "value derived from z": (lambda z: (Y * z[1], z[0], torch.tensor(1.0, dtype=Y.dtype)),
                             False),
    "vector loc": (lambda z: (Y, z[0] + Y, torch.exp(z[1])), False),
    "0-d value": (lambda z: (Y[3], z[0], torch.exp(z[1])), False),
    "requires_grad leaf": (lambda z: (Y_LEAF, z[0], torch.exp(z[1])), False),
    "Python loc": (lambda z: (Y, 0.5, torch.exp(z[1])), False),
    "another dtype": (lambda z: (Y.float(), z[0], torch.exp(z[1])), False),
    "empty data": (lambda z: (Y[:0], z[0], torch.exp(z[1])), False),
}


@pytest.mark.parametrize("case", sorted(ROUTING))
def test_routing_rule_under_vmap(case):
    make_args, routes = ROUTING[case][:2]
    assert _seen_under_vmap(make_args) is routes


@pytest.mark.parametrize("case", sorted(ROUTING))
def test_routing_rule_without_vmap(case):
    make_args, routes = ROUTING[case][0], ROUTING[case][-1]
    z = torch.tensor([0.1, 0.2], dtype=torch.float64, requires_grad=True)
    assert K.normal_plane_routes(*make_args(z)) is routes


def test_routed_log_prob_is_one_plane_call_per_batched_call(monkeypatch, x64):
    """The gmm potential under ``vmap(grad_and_value)`` over 64 chains: its
    two component densities are two forward calls and two backward calls,
    each taking all 64 rows at once."""
    staged = _gmm()  # its discovery run makes two unbatched calls
    calls = []
    for name in ("_plane", "_plane_grad"):
        real = getattr(K, name)

        def spy(*args, real=real, name=name):
            calls.append((name, tuple(args[-2].shape)))
            return real(*args)

        monkeypatch.setattr(K, name, spy)
    vmap(grad_and_value(staged.potential))(_gmm_points(64))
    assert sorted(calls) == [("_plane", (64,))] * 2 + [("_plane_grad", (64,))] * 2, calls


def test_density_count_under_a_profiler(x64):
    """One ``density.normal_plane`` count per batched forward call, recorded
    only while a profiler session runs."""
    staged = _gmm(n=50)
    force = vmap(grad_and_value(staged.potential))
    profiling.clear()
    force(_gmm_points(8))
    assert not profiling.records(0, 2**63)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        force(_gmm_points(8))
    counts = [r for r in profiling.records(0, 2**63)
              if isinstance(r, profiling.Count) and r.name == "density.normal_plane"]
    assert sum(c.n for c in counts) == 2
    profiling.clear()


# -- the gmm potential against the expression it replaces --------------------


def _value_and_grad(staged, q):
    return vmap(grad_and_value(staged.potential))(q)


def _hessians(staged, q):
    return (vmap(hessian(staged.potential))(q[:4]),)


def _reverse_over_reverse(staged, q):
    out = []
    for z in q[:3]:
        z = z.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(staged.potential(z), z, create_graph=True)
        out.append(torch.stack([torch.autograd.grad(g[i], z, retain_graph=True)[0]
                                for i in range(z.numel())]))
    return (torch.stack(out),)


def _autograd_over_vmap_grad(staged, q):
    z = q[:6].clone().requires_grad_(True)
    g = vmap(grad(staged.potential))(z)
    return g, torch.autograd.grad(torch.sum(g * g), z)[0]


def _grad_alone(staged, q):
    return torch.stack([grad(staged.potential)(z) for z in q[:3]]),


@pytest.mark.parametrize("derive", [_value_and_grad, _grad_alone, _hessians, _reverse_over_reverse,
                                    _autograd_over_vmap_grad],
                         ids=["value_and_grad", "grad_alone", "hessian", "reverse_over_reverse",
                              "autograd_over_vmap_grad"])
def test_gmm_potential_equals_the_plain_expression(derive, monkeypatch, x64):
    """C = 64, N = 1,000, float64: the value, gradient and second
    derivatives through the Function equal the plain expression's to
    1e-12 relative (the sums run in another order)."""
    staged, q = _gmm(), _gmm_points(64)
    got = derive(staged, q)
    _plain(monkeypatch)
    want = derive(_gmm(), q)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = ((g - w).abs() / w.abs().clamp(min=1.0)).max().item()
        assert err <= 1e-12, err


@pytest.mark.parametrize("transform", ["vmap_grad", "grad"])
def test_drive_levels_build_their_node_below_functorch(transform, monkeypatch, x64):
    """Under the drives' vmap(grad_and_value) and under grad alone, the
    plane and its sums run below the transforms (``_at_grad().Function``,
    ``_sums_at_grad``) and equal the Functions taken through functorch
    bitwise; a hessian's stack takes the Functions."""
    staged, q = _gmm(), _gmm_points(16)
    if transform == "vmap_grad":
        def run():
            return vmap(grad_and_value(staged.potential))(q)
    else:
        def run():
            return [grad_and_value(staged.potential)(z) for z in q[:2]]
    taken = []
    for name in ("_sums_at_grad", "_drive_levels"):
        real = getattr(K, name)

        def spy(*args, real=real, name=name):
            out = real(*args)
            taken.append((name, out is not None))
            return out

        monkeypatch.setattr(K, name, spy)
    fast = run()
    assert taken and all(ok for _, ok in taken)
    taken.clear()
    hessian(staged.potential)(q[0])
    assert taken and not any(ok for _, ok in taken)
    monkeypatch.setattr(K, "_drive_levels", lambda: None)
    slow = run()
    for f, w in zip(torch.utils._pytree.tree_leaves(fast), torch.utils._pytree.tree_leaves(slow)):
        assert torch.equal(f, w)


@pytest.mark.parametrize("shape", [(), (3,), (2, 3)])
def test_function_derivatives_pass_gradcheck(shape, x64):
    """``_NormalPlane`` and ``_NormalPlaneGrad`` in float64, loc and scale
    of ``shape``, y (5,) with a gradient too: reverse, forward and second
    order against finite differences."""
    gen = torch.Generator().manual_seed(3)
    y = torch.randn(5, generator=gen, dtype=torch.float64, requires_grad=True)
    loc = torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
    scale = (0.5 + torch.rand(shape, generator=gen, dtype=torch.float64)).requires_grad_(True)
    g = torch.randn(shape + (5,), generator=gen, dtype=torch.float64, requires_grad=True)
    kw = dict(check_forward_ad=True, check_backward_ad=True, check_batched_grad=True)
    assert torch.autograd.gradcheck(K._NormalPlane.apply, (y, loc, scale), **kw)
    assert torch.autograd.gradgradcheck(K._NormalPlane.apply, (y, loc, scale))
    assert torch.autograd.gradcheck(K._NormalPlaneGrad.apply, (g, y, loc, scale), **kw)


def test_plane_and_its_sums_equal_the_log_prob_expression(x64):
    gen = torch.Generator().manual_seed(4)
    y = torch.randn(6, 4, generator=gen, dtype=torch.float64)
    loc, scale = torch.randn(3, generator=gen), 0.5 + torch.rand(3, generator=gen)
    loc, scale = loc.double(), scale.double()
    want = torch.stack([-0.5 * ((y - m) / s) ** 2 - torch.log(s) - 0.5 * math.log(2 * math.pi)
                        for m, s in zip(loc, scale)])
    torch.testing.assert_close(K.normal_plane(y, loc, scale), want, rtol=1e-15, atol=0)
    g = torch.randn(3, 6, 4, generator=gen, dtype=torch.float64)
    m, s = loc.clone().requires_grad_(True), scale.clone().requires_grad_(True)
    plain = -0.5 * ((y - m[:, None, None]) / s[:, None, None]) ** 2 - torch.log(s)[:, None, None]
    dm, ds = torch.autograd.grad(torch.sum(g * plain), (m, s))
    got = K.normal_plane_grad_ref(g, y, loc, scale)
    torch.testing.assert_close(got[0], dm, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got[1], ds, rtol=1e-12, atol=1e-12)


def test_data_batched_under_vmap_is_refused():
    with pytest.raises(ValueError, match="must not be batched"):
        vmap(K.normal_plane, in_dims=(0, None, None))(torch.ones(3, 4), torch.zeros(()),
                                                         torch.ones(()))


# -- the models that bypass it, op for op -----------------------------------


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _eight_schools():
    return ftt.stage(harness.config("eight_schools_nc").build(0, "cpu").model_fn, device="cpu")


def _eight_schools_dsl():
    config = harness.config("eight_schools_nc")
    model = compile_model(config.DSL).build(config.DSL_DATA, device="cpu")
    return ftt.stage(model, device="cpu")


@pytest.mark.parametrize("make", [_eight_schools, _eight_schools_dsl],
                         ids=["eight_schools_nc", "eight_schools_nc_dsl"])
def test_bypassed_potential_runs_the_same_ops(make, monkeypatch):
    """The benchmark's eight-schools potentials (the HMC cell's and the
    serve cell's DSL copy), one batched value-and-gradient over 16 chains:
    the same aten ops in the same order as with routing off."""
    q = torch.as_tensor(np.random.default_rng(2).normal(0.0, 0.5, (16, 10)),
                        dtype=torch.float32)
    runs = []
    for off in (False, True):
        if off:
            _plain(monkeypatch)
        staged, mode = make(), _Ops()
        with mode:
            g, u = vmap(grad_and_value(staged.potential))(q)
        runs.append((mode.ops, g, u))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) > 50
    assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[0][2], runs[1][2])


# -- the kernel's layout, mirrored -------------------------------------------

TILE = K._PLANE_TILE


def _mirror_row(y, row_offset, t0, length, w):
    """The element indices of y that normal_plane.cu's row walk reads for a
    row whose tile segment starts ``row_offset`` elements past a 16-byte
    boundary, in the order it writes them: the head, the vectors (each one
    aligned read of the shifted copy), the tail. Raises on a misaligned
    vector read or an element outside the staged copy."""
    lc = (min(len(y), TILE) + 2 * w - 2) // w * w
    copies = np.full((w, lc), np.nan)
    for r in range(w):
        copies[r, r:r + length] = y[t0:t0 + length]
    head = min((w - row_offset % w) % w, length)
    n_vec = (length - head) // w
    r = (w - head) % w
    flat = copies.reshape(-1)
    base = r * lc + r  # element i of the tile at flat[base + i]
    out = [flat[base + i] for i in range(head)]
    for v in range(n_vec):
        start = base + head + w * v
        assert start % w == 0, "a vector read of shared memory is not aligned"
        out.extend(flat[start:start + w])
    out.extend(flat[base + head + w * n_vec + j] for j in range(length - head - w * n_vec))
    assert not np.isnan(out).any(), "read outside the staged copy"
    return np.asarray(out)


@pytest.mark.parametrize("w", [4, 2], ids=["float32", "float64"])
@pytest.mark.parametrize("n", [1, 3, 5, 1000, 1001, TILE + 7, 2 * TILE + 1])
def test_layout_mirror_reads_every_element_once_in_order(w, n):
    y = np.arange(n, dtype=np.float64) + 0.5
    for t0 in range(0, n, TILE):
        length = min(TILE, n - t0)
        for row_offset in range(w):
            np.testing.assert_array_equal(_mirror_row(y, row_offset, t0, length, w),
                                          y[t0:t0 + length])


def test_grid_takes_eight_blocks_per_sm_or_one_per_eight_rows():
    assert K._plane_blocks(131072, 132) == 8 * 132
    assert K._plane_blocks(3, 132) == 1
    assert K._plane_blocks(17, 132) == 3


def test_wrapper_checks_what_the_kernel_takes():
    y, one = torch.zeros(10), torch.ones(1)
    with pytest.raises(TypeError):
        K._check_plane(y, one.double(), one)
    with pytest.raises(ValueError):
        K._check_plane(y, torch.ones(2), one)
    with pytest.raises(ValueError):
        meta = torch.ones(1, device="meta")
        K._check_plane(torch.zeros(65535 * TILE + 1, device="meta"), meta, meta)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    settings.enable_x64(False)
    yield
    settings.enable_x64(False)


def _rows(c, n, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = 0.5 + 2.0 * torch.randn(n, generator=g, device="cuda", dtype=dtype)
    loc = torch.randn(c, generator=g, device="cuda", dtype=dtype)
    scale = 0.5 + torch.rand(c, generator=g, device="cuda", dtype=dtype)
    cot = torch.randn(c, n, generator=g, device="cuda", dtype=dtype)
    return y, loc, scale, cot


def _tol(dtype):
    return dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("c, n", [(131072, 1000), (1, 1), (3, 1), (1, 3), (3, 3), (1, 1001),
                                  (3, 1001), (5, 2 * TILE + 3)])
def test_kernels_equal_the_plain_version(c, n, dtype, cuda):
    y, loc, scale, cot = _rows(c, n, dtype)
    before = dict(K.LAUNCHES)
    got = K._plane(y, loc, scale)
    dloc, dscale = K._plane_grad(cot, y, loc, scale)
    torch.cuda.synchronize()
    assert K.LAUNCHES["normal_plane"] == before["normal_plane"] + 1
    assert K.LAUNCHES["normal_plane_grad"] == before["normal_plane_grad"] + 1
    torch.testing.assert_close(got, K.normal_plane_ref(y, loc, scale), **_tol(dtype))
    want = K.normal_plane_grad_ref(cot, y, loc, scale)
    # a row's sums: float32 rounding of n terms of size about |g z|
    scale_of = (cot.abs() * 4.0).sum(-1) / scale if dtype == torch.float32 else 1.0
    for k, p in zip((dloc, dscale), want):
        assert ((k - p).abs() <= 1e-6 * scale_of + 1e-12 * p.abs()).all()
    again = K._plane_grad(cot, y, loc, scale)
    assert torch.equal(again[0], dloc) and torch.equal(again[1], dscale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_backward_reads_a_strided_cotangent_in_place(dtype, cuda):
    """A cotangent that is a view: every other row of a wider plane, its
    rows starting at an odd element, and a broadcast row (stride 0)."""
    y, loc, scale, _ = _rows(6, 1001, dtype, seed=2)
    wide = torch.randn(12, 1003, device="cuda", dtype=dtype)
    for cot in (wide[::2, 1:1002], torch.randn(1001, device="cuda", dtype=dtype).expand(6, 1001)):
        assert not cot.is_contiguous()
        got = K._plane_grad(cot, y, loc, scale)
        want = K.normal_plane_grad_ref(cot, y, loc, scale)
        for k, p in zip(got, want):
            torch.testing.assert_close(k, p, rtol=1e-4 if dtype == torch.float32 else 1e-12,
                                       atol=1e-3 if dtype == torch.float32 else 1e-10)


def _tensors(transition):
    """(q_out, info, q_new, p_new) as a list of tensors, info's fields in
    their order."""
    q_out, info, q_new, p_new = transition
    return [q_out, *vars(info).values(), q_new, p_new]


@pytest.mark.gpu
def test_a_routed_models_captured_transition_replays_as_eager(monkeypatch, cuda):
    """The gmm potential (float32, N = 1,000, 512 chains) through
    ``hmc.TransitionGraphs`` with L = 4: the first call runs eagerly and
    captures, later replays equal the eager transition bitwise (NaN where
    it has NaN), and the capture launched the kernels."""
    staged = _gmm("cuda", torch.float32)
    q = _gmm_points(512, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(5)
    graphs = hmc.TransitionGraphs()
    inv_mass = torch.ones(5, device="cuda")
    eps = torch.tensor(0.01, device="cuda")
    before = dict(K.LAUNCHES)
    for step in range(4):
        p = torch.randn(q.shape, generator=gen, device="cuda")
        log_u = torch.log(torch.rand(512, generator=gen, device="cuda"))
        got = [t.clone() for t in _tensors(
            graphs.transition(staged.potential, q, p, log_u, eps, 4, inv_mass, 1000.0))]
        want = hmc.leapfrog_transition(hmc.batched_force(staged.potential), q, p, log_u, eps, 4,
                                       inv_mass, 1000.0)
        assert len(got) == len(_tensors(want)) == 8
        for g, w in zip(got, _tensors(want)):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                       msg=lambda m: f"step {step}: {m}")
        q = want[0]
    torch.cuda.synchronize()
    assert not graphs.failed and len(graphs.entries) == 1
    assert K.LAUNCHES["normal_plane"] > before["normal_plane"]
    assert K.LAUNCHES["normal_plane_grad"] > before["normal_plane_grad"]
