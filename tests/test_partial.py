"""Partial-assembly hot path: transposed kernels, lattice gather/scatter."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cmfem_tpu.core import FESpace, make_cartesian_mesh_3d, make_cartesian_mesh_2d
from cmfem_tpu.ops import SpaceOps, BilinearForm
from cmfem_tpu.ops.partial import (
    PAOperator, StructuredGrid3D, StructuredPAOperator, pack_qp_blocks_T,
)


def _setup(n=3, order=2):
    mesh = make_cartesian_mesh_3d(n, n, n)
    fes = FESpace(mesh, order)
    ops = SpaceOps(fes, quad_order=2 * order)
    form = (BilinearForm(ops)
            .add_diffusion(0.3)
            .add_convection(np.array([1.0, -2.0, 0.5]))
            .add_mass(1.0))
    data = form.assemble()
    return mesh, fes, ops, form, data


def test_pa_operator_matches_bilinear_apply():
    mesh, fes, ops, form, data = _setup()
    op = PAOperator(ops, data, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(fes.nscalar))
    y_ref = form.apply(data, u)
    y_pa = op(u)
    np.testing.assert_allclose(np.asarray(y_pa), np.asarray(y_ref),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_structured_operator_matches_unstructured(order):
    n = 3
    mesh = make_cartesian_mesh_3d(n, n, n)
    fes = FESpace(mesh, order)
    ops = SpaceOps(fes, quad_order=2 * order)
    form = (BilinearForm(ops)
            .add_diffusion(0.3)
            .add_convection(np.array([1.0, -2.0, 0.5]))
            .add_mass(1.0))
    data = form.assemble()
    grid = StructuredGrid3D(n, n, n, order)
    assert grid.ndofs == fes.nscalar

    # map entity numbering -> lattice numbering by node position
    pos = np.asarray(fes.node_positions)
    pi = np.round(pos * (grid.NX - 1) / 1.0).astype(np.int64)
    lat = (pi[:, 2] * grid.NY + pi[:, 1]) * grid.NX + pi[:, 0]
    assert len(np.unique(lat)) == grid.ndofs

    rng = np.random.default_rng(1)
    u_ent = rng.standard_normal(fes.nscalar)
    u_lat = np.zeros(grid.ndofs)
    u_lat[lat] = u_ent

    y_ref = np.asarray(form.apply(data, jnp.asarray(u_ent)))
    sop = StructuredPAOperator(ops, data, grid, dtype=jnp.float64)
    y_lat = np.asarray(sop(jnp.asarray(u_lat)))
    np.testing.assert_allclose(y_lat[lat], y_ref, rtol=1e-11, atol=1e-11)


def test_structured_boundary_mask():
    grid = StructuredGrid3D(3, 3, 3, 2)
    mask = grid.boundary_mask()
    assert mask.sum() == grid.ndofs - (grid.NX - 2) ** 3


def test_pack_blocks_layout():
    mesh, fes, ops, form, data = _setup(n=2, order=1)
    Dflat, BG = pack_qp_blocks_T(ops, data, dtype=jnp.float64)
    ne, nq = ops.gf.wdetJ.shape
    assert Dflat.shape == (16, nq, ne)
    assert BG.shape == (4 * nq, 8)
    # row 0..nq-1 of BG are shape values: partition of unity
    np.testing.assert_allclose(np.asarray(BG[:nq]).sum(axis=1), 1.0,
                               atol=1e-12)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_sumfact_matches_reference_apply(order):
    """Global sum-factorized apply is exact vs the generic path."""
    import jax.numpy as jnp
    from cmfem_tpu.ops.sumfact import SumFactoredOperator

    n = 3
    mesh = make_cartesian_mesh_3d(n, n, n)
    fes = FESpace(mesh, order)
    ops = SpaceOps(fes, quad_order=2 * order)
    form = (BilinearForm(ops)
            .add_diffusion(0.3)
            .add_convection(np.array([1.0, -2.0, 0.5]))
            .add_mass(1.0))
    data = form.assemble()
    grid = StructuredGrid3D(n, n, n, order)
    sfop = SumFactoredOperator(ops, data, n, n, n, order, dtype=jnp.float64)

    pos = np.asarray(fes.node_positions)
    pi = np.round(pos * (grid.NX - 1)).astype(np.int64)
    lat = (pi[:, 2] * grid.NY + pi[:, 1]) * grid.NX + pi[:, 0]
    rng = np.random.default_rng(0)
    u_ent = rng.standard_normal(fes.nscalar)
    u_lat = np.zeros(grid.ndofs)
    u_lat[lat] = u_ent
    y_ref = np.asarray(form.apply(data, jnp.asarray(u_ent)))
    y_lat = np.asarray(sfop(jnp.asarray(u_lat)))
    scale = np.abs(y_ref).max()
    np.testing.assert_allclose(y_lat[lat] / scale, y_ref / scale, atol=1e-13)


def test_sumfact_periodic_paths_match_generic():
    """z-periodic D compression is exact vs the generic lattice-D apply
    on a uniform grid, and the periodicity detector rejects
    variable-coefficient operators."""
    import jax.numpy as jnp

    from cmfem_tpu.ops.sumfact import SumFactoredOperator

    nx, ny, nz = 3, 4, 5
    mesh = make_cartesian_mesh_3d(nx, ny, nz)
    fes = FESpace(mesh, 2)
    ops = SpaceOps(fes, quad_order=4)
    form = (BilinearForm(ops)
            .add_diffusion(0.3)
            .add_convection(np.array([1.0, -2.0, 0.5]))
            .add_mass(1.0))
    data = form.assemble()
    sfop = SumFactoredOperator(ops, data, nx, ny, nz, 2, dtype=jnp.float64)
    assert sfop.periodic and sfop.z_periodic

    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.standard_normal(sfop.ndofs))
    fn, D = sfop.bind()
    y_ref = np.asarray(fn(u, D))
    scale = np.abs(y_ref).max()

    fnp, Dp = sfop.bind(use_periodic=True)
    np.testing.assert_allclose(np.asarray(fnp(u, Dp)) / scale,
                               y_ref / scale, atol=1e-13)

    # variable coefficient -> not periodic, and the periodic bind refuses
    import jax

    xq = np.asarray(ops.gf.xq)
    kappa_q = jnp.asarray(0.1 + xq[..., 2] ** 2)   # z-varying
    form_v = BilinearForm(ops).add_diffusion(kappa_q).add_mass(1.0)
    sfop_v = SumFactoredOperator(ops, form_v.assemble(), nx, ny, nz, 2,
                                 dtype=jnp.float64)
    assert not sfop_v.z_periodic
    try:
        sfop_v.bind(use_periodic=True)
        assert False, "expected ValueError"
    except ValueError:
        pass


@pytest.mark.parametrize("order", [1, 2, 3])
def test_best_bind_choice_matches_bind(order):
    """best_bind takes the z-periodic path exactly when the operator is
    z-periodic and compressed, and agrees with the plain bind()."""
    from cmfem_tpu.ops.sumfact import SumFactoredOperator

    nx, ny, nz = 3, 2, 4
    mesh = make_cartesian_mesh_3d(nx, ny, nz)
    ops = SpaceOps(FESpace(mesh, order), quad_order=2 * order)
    xq = np.asarray(ops.gf.xq)
    forms = {
        "uniform": BilinearForm(ops).add_diffusion(0.3)
        .add_convection(np.array([1.0, -2.0, 0.5])).add_mass(1.0),
        "z-varying": BilinearForm(ops)
        .add_diffusion(jnp.asarray(0.1 + xq[..., 2] ** 2)).add_mass(1.0),
    }
    rng = np.random.default_rng(order)
    for name, form in forms.items():
        sfop = SumFactoredOperator(ops, form.assemble(), nx, ny, nz, order,
                                   dtype=jnp.float64)
        fn_b, D_b = sfop.best_bind()
        periodic = sfop.z_periodic and sfop.compressed
        assert periodic == (name == "uniform")
        assert D_b is (sfop.Dz if periodic else sfop.D)
        fn, D = sfop.bind()
        u = jnp.asarray(rng.standard_normal(sfop.ndofs))
        y = np.asarray(fn(u, D))
        np.testing.assert_allclose(np.asarray(fn_b(u, D_b)) / np.abs(y).max(),
                                   y / np.abs(y).max(), atol=1e-13)
        assert sfop.min_bytes(periodic) == (
            D_b.size * 8 + 2 * sfop.ndofs * 8)


@pytest.mark.parametrize("structured", [False, True])
def test_pa_operators_with_defaults_match_bilinear_apply(structured):
    """PAOperator and StructuredPAOperator built with their defaults
    (float32) agree with the float64 element apply to f32 rounding."""
    n, order = 3, 2
    mesh, fes, ops, form, data = _setup(n=n, order=order)
    u_ent = np.random.default_rng(5).standard_normal(fes.nscalar)
    y_ref = np.asarray(form.apply(data, jnp.asarray(u_ent)))
    if structured:
        grid = StructuredGrid3D(n, n, n, order)
        lat = grid.lattice_index(fes.node_positions)
        u_lat = np.zeros(grid.ndofs)
        u_lat[lat] = u_ent
        op = StructuredPAOperator(ops, data, grid)
        y = np.asarray(op(jnp.asarray(u_lat)))[lat]
    else:
        op = PAOperator(ops, data)
        y = np.asarray(op(jnp.asarray(u_ent)))
    assert op.dtype == jnp.float32 and y.dtype == np.float32
    scale = np.abs(y_ref).max()
    np.testing.assert_allclose(y / scale, y_ref / scale, atol=2e-6)
