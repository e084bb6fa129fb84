"""Core layer tests: reference elements, quadrature, mesh, fespace, geometry."""

import numpy as np
import pytest

from cmfem_tpu.core import (
    get_reference_element,
    gauss_rule,
    load_gmsh,
    make_cartesian_mesh_2d,
    make_cartesian_mesh_3d,
    FESpace,
)
from cmfem_tpu.core.geometry import factors_for
from cmfem_tpu.core.reference_elements import (
    SEGMENT, TRIANGLE, QUAD, HEXAHEDRON,
)

MESH_DIR = "/root/reference/myapps/convection_diffusion/Mesh"


@pytest.mark.parametrize("geom,order", [
    (SEGMENT, 1), (SEGMENT, 2), (SEGMENT, 3),
    (TRIANGLE, 1), (TRIANGLE, 2), (TRIANGLE, 3),
    (QUAD, 1), (QUAD, 2), (QUAD, 3),
    (HEXAHEDRON, 1), (HEXAHEDRON, 2), (HEXAHEDRON, 3),
])
def test_partition_of_unity(geom, order):
    ref = get_reference_element(geom, order)
    q = gauss_rule(geom, 2 * order)
    B, G = ref.eval(q.points)
    assert B.shape == (q.nqp, ref.ndof)
    np.testing.assert_allclose(B.sum(axis=1), 1.0, atol=1e-12)
    np.testing.assert_allclose(G.sum(axis=1), 0.0, atol=1e-11)


@pytest.mark.parametrize("geom,order", [
    (TRIANGLE, 2), (QUAD, 3), (HEXAHEDRON, 2),
])
def test_nodal_interpolation_property(geom, order):
    """Basis i equals 1 at node i, 0 at others (Lagrange property)."""
    ref = get_reference_element(geom, order)
    B, _ = ref.eval(ref.nodes)
    np.testing.assert_allclose(B, np.eye(ref.ndof), atol=1e-10)


@pytest.mark.parametrize("geom,vol", [
    (SEGMENT, 1.0), (TRIANGLE, 0.5), (QUAD, 1.0), (HEXAHEDRON, 1.0),
])
def test_quadrature_volume(geom, vol):
    for order in range(1, 8):
        q = gauss_rule(geom, order)
        np.testing.assert_allclose(q.weights.sum(), vol, rtol=1e-12)


def test_quadrature_polynomial_exactness_triangle():
    q = gauss_rule(TRIANGLE, 5)
    # integral of x^a y^b over unit triangle = a! b! / (a+b+2)!
    from math import factorial
    for a in range(4):
        for b in range(4):
            if a + b > 5:
                continue
            exact = factorial(a) * factorial(b) / factorial(a + b + 2)
            got = np.sum(q.weights * q.points[:, 0] ** a * q.points[:, 1] ** b)
            np.testing.assert_allclose(got, exact, rtol=1e-12)


def test_load_gmsh_unit_square():
    m = load_gmsh(f"{MESH_DIR}/unit_square.msh")
    assert m.dim == 2
    lo, hi = m.bounding_box()
    np.testing.assert_allclose(lo, [0, 0], atol=1e-12)
    np.testing.assert_allclose(hi, [1, 1], atol=1e-12)
    assert set(m.bdr_attributes) == {1, 2, 3, 4}
    # total area via geometric factors
    q = gauss_rule(m.geom, 2)
    gf = factors_for(m, q)
    np.testing.assert_allclose(float(gf.wdetJ.sum()), 1.0, rtol=1e-10)


def test_load_gmsh_ablation_strip():
    m = load_gmsh(f"{MESH_DIR}/ablation_strip.msh")
    assert m.geom == QUAD
    q = gauss_rule(m.geom, 2)
    gf = factors_for(m, q)
    lo, hi = m.bounding_box()
    np.testing.assert_allclose(float(gf.wdetJ.sum()),
                               np.prod(hi - lo), rtol=1e-10)
    assert set(m.bdr_attributes) == {1, 2, 3}


def test_load_gmsh_circle_tri():
    m = load_gmsh(f"{MESH_DIR}/unit_circle.msh")
    assert m.geom == TRIANGLE
    q = gauss_rule(m.geom, 2)
    gf = factors_for(m, q)
    # polygonal approx of unit disk, pi to ~1e-2
    np.testing.assert_allclose(float(gf.wdetJ.sum()), np.pi, rtol=5e-3)


def test_uniform_refine_quad_area_and_count():
    m = load_gmsh(f"{MESH_DIR}/unit_square.msh")
    m2 = m.uniform_refine()
    assert m2.num_elements == 4 * m.num_elements
    assert m2.num_bdr_faces == 2 * m.num_bdr_faces
    q = gauss_rule(m2.geom, 2)
    gf = factors_for(m2, q)
    np.testing.assert_allclose(float(gf.wdetJ.sum()), 1.0, rtol=1e-10)


def test_uniform_refine_hex():
    m = make_cartesian_mesh_3d(2, 2, 2)
    m2 = m.uniform_refine()
    assert m2.num_elements == 8 * m.num_elements
    q = gauss_rule(m2.geom, 2)
    gf = factors_for(m2, q)
    np.testing.assert_allclose(float(gf.wdetJ.sum()), 1.0, rtol=1e-10)


@pytest.mark.parametrize("order,expected", [(1, 25), (2, 81), (3, 169)])
def test_fespace_dof_counts_quad(order, expected):
    # 4x4 quad grid: (4p+1)^2 dofs
    m = make_cartesian_mesh_2d(4, 4)
    fes = FESpace(m, order)
    assert fes.nscalar == expected


@pytest.mark.parametrize("order", [1, 2, 3])
def test_fespace_dof_counts_hex(order):
    n = 3
    m = make_cartesian_mesh_3d(n, n, n)
    fes = FESpace(m, order)
    assert fes.nscalar == (n * order + 1) ** 3


@pytest.mark.parametrize("geom", [QUAD, TRIANGLE])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_node_positions_interpolate_linear(geom, order):
    """Interpolating a linear function must be exact, and shared dofs must
    agree between elements (continuity of the enumeration)."""
    m = make_cartesian_mesh_2d(3, 3, geom=geom)
    fes = FESpace(m, order)
    u = fes.interpolate(lambda x: 2.0 * x[:, 0] - 3.0 * x[:, 1] + 0.5)
    # evaluate per element at random ref points and compare
    ref = fes.ref
    pts = np.array([[0.3, 0.2], [0.7, 0.6]]) if geom == QUAD else \
        np.array([[0.2, 0.3], [0.1, 0.5]])
    B, _ = ref.eval(pts)
    geo = get_reference_element(geom, 1)
    Bg, _ = geo.eval(pts)
    coords = m.vertices[m.elem_conn]
    xphys = np.einsum("qn,end->eqd", Bg, coords)
    uh = np.einsum("qn,en->eq", B, u[fes.element_dofs])
    expect = 2.0 * xphys[..., 0] - 3.0 * xphys[..., 1] + 0.5
    np.testing.assert_allclose(uh, expect, atol=1e-11)


@pytest.mark.parametrize("order", [2, 3])
def test_hex_face_dof_continuity(order):
    """High-order hex: interpolation of a smooth poly must be single-valued
    on shared faces (exercises face orientation mapping)."""
    m = make_cartesian_mesh_3d(2, 2, 2)
    fes = FESpace(m, order)

    def f(x):
        return x[:, 0] ** 2 + 2 * x[:, 1] * x[:, 2] - x[:, 2]

    u = fes.interpolate(f)
    ref = fes.ref
    pts = np.array([[0.25, 0.5, 0.75], [0.6, 0.1, 0.9]])
    B, _ = ref.eval(pts)
    geo = get_reference_element(HEXAHEDRON, 1)
    Bg, _ = geo.eval(pts)
    coords = m.vertices[m.elem_conn]
    xphys = np.einsum("qn,end->eqd", Bg, coords)
    uh = np.einsum("qn,en->eq", B, u[fes.element_dofs])
    expect = (xphys[..., 0] ** 2 + 2 * xphys[..., 1] * xphys[..., 2]
              - xphys[..., 2])
    if order >= 2:
        np.testing.assert_allclose(uh, expect, atol=1e-10)


def test_essential_dofs_unit_square():
    m = make_cartesian_mesh_2d(4, 4)
    fes = FESpace(m, 2)
    ess = fes.boundary_dofs()
    # boundary nodes of a 4x4 order-2 grid: ring of 8*4 = 32 nodes
    assert len(ess) == 32
    pts = fes.node_positions[ess]
    on_b = (np.abs(pts) < 1e-12) | (np.abs(pts - 1) < 1e-12)
    assert np.all(on_b.any(axis=1))


def test_boundary_face_normals_outward():
    m = make_cartesian_mesh_2d(3, 3)
    fes = FESpace(m, 1)
    from cmfem_tpu.core.geometry import compute_face_factors
    from cmfem_tpu.core.reference_elements import get_reference_element as gre
    fref = gre(SEGMENT, 1)
    q = gauss_rule(SEGMENT, 2)
    Bf, Gf = fref.eval(q.points)
    coords = m.vertices[m.bdr_conn]
    ff = compute_face_factors(coords, Bf, Gf, q.weights, fes.bdr.normal_sign)
    # total boundary length = 4
    np.testing.assert_allclose(float(ff.wdS.sum()), 4.0, rtol=1e-12)
    # all normals point away from the center
    ctr = np.array([0.5, 0.5])
    d = np.einsum("fqd,fqd->fq", np.asarray(ff.normal),
                  np.asarray(ff.xq) - ctr)
    assert (d > 0).all()


def test_native_gmsh_matches_python_reader():
    """Native C++ parser produces the same mesh as the Python reader."""
    from cmfem_tpu.core.mesh import load_gmsh

    for name in ("unit_square", "ablation_strip", "unit_circle"):
        path = f"{MESH_DIR}/{name}.msh"
        m_py = load_gmsh(path, use_native=False)
        m_nat = load_gmsh(path, use_native=True)
        assert m_py.geom == m_nat.geom
        np.testing.assert_array_equal(m_py.elem_conn, m_nat.elem_conn)
        np.testing.assert_allclose(m_py.vertices, m_nat.vertices, atol=0)
        np.testing.assert_array_equal(m_py.bdr_attr, m_nat.bdr_attr)


def test_rcb_partition_balanced_and_local():
    from cmfem_tpu.core.mesh import load_gmsh
    from cmfem_tpu.parallel.partition import partition_elements

    m = load_gmsh(f"{MESH_DIR}/unit_square.msh")
    for nparts in (4, 8):
        parts = partition_elements(m, nparts)
        counts = np.bincount(parts, minlength=nparts)
        assert counts.min() >= m.num_elements // nparts - 1
        assert counts.max() <= m.num_elements // nparts + 2
        # locality: each part's bbox area well below the domain area
        cents = m.vertices[m.elem_conn].mean(axis=1)
        for k in range(nparts):
            c = cents[parts == k]
            area = np.prod(c.max(axis=0) - c.min(axis=0))
            assert area < 2.0 / nparts


def test_default_matmul_precision_is_highest():
    """Importing cmfem_tpu must pin true-f32 matmuls globally: a reduced
    default precision (TF32 on NVIDIA GPUs) truncates operands, which
    corrupts assembled geometric factors on fine meshes."""
    import jax
    import cmfem_tpu  # noqa: F401

    assert str(jax.config.jax_default_matmul_precision) == "highest"


def test_native_edge_enumeration_consistent():
    """The native edge enumerator partitions edges identically to the
    numpy path (ids up to relabeling; directions by min->max vertex)."""
    from cmfem_tpu.core.mesh import load_gmsh
    from cmfem_tpu.core.reference_elements import GEOM_EDGES
    from cmfem_tpu.native import enumerate_edges_native

    m = load_gmsh(f"{MESH_DIR}/unit_square.msh")
    edges = GEOM_EDGES[m.geom]
    out = enumerate_edges_native(m.elem_conn, edges)
    if out is None:
        pytest.skip("native library unavailable")
    ids, dirs, n = out
    conn = m.elem_conn.astype(np.int64)
    a = np.stack([conn[:, e[0]] for e in edges], 1)
    b = np.stack([conn[:, e[1]] for e in edges], 1)
    key = np.minimum(a, b) * (conn.max() + 1) + np.maximum(a, b)
    # same number of unique edges; ids must be a function of the key
    assert n == len(np.unique(key))
    pairs = {}
    for k, i in zip(key.ravel(), np.asarray(ids).ravel()):
        assert pairs.setdefault(int(k), int(i)) == int(i)
    # directions: +1 iff a < b
    np.testing.assert_array_equal(np.asarray(dirs), np.where(a < b, 1, -1))


def test_native_locator_matches_numpy_sweep():
    """The native bucket-grid candidate stage (native/cmfem_native.cpp
    locator_*) resolves points to the same elements and reference coords
    as the dense numpy bbox sweep, including out-of-mesh points."""
    import numpy as np

    from cmfem_tpu.core import make_cartesian_mesh_2d, make_cartesian_mesh_3d
    from cmfem_tpu.core.pointlocate import locate_points
    from cmfem_tpu.native import NativeLocator

    for mesh in (make_cartesian_mesh_2d(17, 11),
                 make_cartesian_mesh_2d(10, 9, geom="triangle"),
                 make_cartesian_mesh_3d(5, 4, 3)):
        loc = NativeLocator.build(np.asarray(mesh.vertices),
                                  np.asarray(mesh.elem_conn), 1e-9)
        if loc is None:
            import pytest
            pytest.skip("native library unavailable")
        rng = np.random.default_rng(7)
        lo, hi = mesh.bounding_box()
        pts = lo + (hi - lo) * rng.random((400, mesh.dim))
        pts[:20] = hi + 0.5  # outside
        ids_ref, refs_ref = locate_points(mesh, pts)  # numpy path (small)
        ip, ie = loc.query(pts)
        order = np.lexsort((ie, ip))
        ip, ie = ip[order], ie[order]
        # native candidates must contain every numpy hit
        found = ids_ref >= 0
        assert found.sum() == 380
        cand = {(int(a), int(b)) for a, b in zip(ip, ie)}
        for pidx in np.nonzero(found)[0]:
            assert (int(pidx), int(ids_ref[pidx])) in cand
        # and the full pipeline agrees pair-for-pair on a large batch
        big = lo + (hi - lo) * rng.random((12000, mesh.dim))
        ids_n, refs_n = locate_points(mesh, big)      # native path if big
        ids_chunk = np.concatenate([
            locate_points(mesh, big[s:s + 500])[0]
            for s in range(0, len(big), 500)])
        assert (ids_n == ids_chunk).all()


def test_locator_cache_invalidates_on_connectivity():
    """The one-entry locator cache digests BOTH vertices and
    connectivity: id(mesh) can be recycled after garbage collection, so
    identical vertex bytes with renumbered elements must miss the cache
    (stale hits would return element ids of the old numbering)."""
    import numpy as np

    from cmfem_tpu.core import make_cartesian_mesh_2d
    from cmfem_tpu.core.pointlocate import _cached_native_locator

    mesh = make_cartesian_mesh_2d(6, 5)
    verts = np.asarray(mesh.vertices)
    conn = np.asarray(mesh.elem_conn)
    loc_a = _cached_native_locator(mesh, verts, conn, 1e-9)
    if loc_a is None:
        import pytest
        pytest.skip("native library unavailable")
    assert _cached_native_locator(mesh, verts, conn, 1e-9) is loc_a
    # same mesh identity + same vertices, permuted element numbering
    perm = np.arange(len(conn))[::-1]
    loc_b = _cached_native_locator(mesh, verts, conn[perm], 1e-9)
    assert loc_b is not loc_a
    pts = verts[:8] + 1e-3
    ip_a, ie_a = loc_b.query(pts)
    ip_c, ie_c = _cached_native_locator(mesh, verts, conn[perm],
                                        1e-9).query(pts)
    assert (ie_a == ie_c).all()


def test_sorted_tuple_keys_no_overflow_collisions():
    """Face-key packing must stay collision-free above the ~55k-vertex
    int64 limit of direct base-kmax packing (the 48^3 bench mesh already
    wraps): distinct tuples get distinct keys, equal tuples equal keys,
    and cross-array matching stays lexicographically consistent."""
    from cmfem_tpu.core.fespace import _sorted_tuple_keys

    rng = np.random.default_rng(11)
    kmax = 2_000_000
    a = np.sort(rng.integers(0, kmax, size=(4000, 4)), axis=1)
    b = a[rng.permutation(4000)[:500]]          # subset, shuffled
    ka, kb = _sorted_tuple_keys(a, b)
    # direct packing would overflow: kmax^4 >> 2^63 (Python ints — the
    # int64 power itself wraps, which is the point)
    assert int(a.max() + 1) ** 4 > 2**63
    # equal tuples -> equal keys (match b back into a)
    uniq = np.unique(ka)
    pos = np.searchsorted(uniq, kb)
    assert (uniq[pos] == kb).all()
    # distinct tuples -> distinct keys
    ua, inv = np.unique(ka, return_inverse=True)
    for g in range(len(ua)):
        rows = a[inv == g]
        assert (rows == rows[0]).all()
    # lexicographic order preserved
    order = np.lexsort(a.T[::-1])
    assert (np.diff(ka[order]) >= 0).all()


def test_gauss_lobatto_general_branch_interpolatory():
    """Orders >= 5 (the general Legendre-roots branch) must return p+1
    interpolatory nodes; selecting P_{p-1} silently returned only p."""
    from cmfem_tpu.core.reference_elements import (
        gauss_lobatto_nodes, _lagrange_1d,
    )

    for p in (5, 6, 7):
        nodes = gauss_lobatto_nodes(p)
        assert len(nodes) == p + 1
        V, _ = _lagrange_1d(nodes, nodes)
        assert np.abs(V - np.eye(p + 1)).max() < 1e-10


def test_locate_points_tolerates_degenerate_simplex():
    """One collapsed triangle (zero area, as during extreme ALE motion)
    must not crash the whole locate_points batch with LinAlgError."""
    from cmfem_tpu.core import make_cartesian_mesh_2d
    from cmfem_tpu.core.pointlocate import locate_points

    mesh = make_cartesian_mesh_2d(4, 4, geom="triangle")
    verts = np.asarray(mesh.vertices).copy()
    # collapse element 0 onto a single point
    conn0 = np.asarray(mesh.elem_conn)[0]
    verts[conn0] = verts[conn0[0]]
    pts = np.array([[0.6, 0.6], [0.9, 0.1], [2.0, 2.0]])
    ids, refs = locate_points(mesh, pts, vertices=verts)
    assert ids[0] >= 0 and ids[1] >= 0    # found in healthy elements
    assert ids[2] == -1                   # outside stays not-found
    assert np.isfinite(refs[:2]).all()


def test_front_depth_both_crossing_directions():
    """front_depth must find the tau front in the physical (charred
    surface -> virgin depth, i.e. increasing-with-depth) orientation.

    The reference's ComputeFrontDepth
    (ablation_test_case1_2D.cpp:779-819) only detects decreasing
    crossings, which never occur for the tau field it samples — our
    front_depth is an intentional superset (see its docstring)."""
    from cmfem_tpu.core.mesh import make_cartesian_mesh_2d
    from cmfem_tpu.core.pointlocate import front_depth

    ny = 40
    mesh = make_cartesian_mesh_2d(2, ny, sx=0.01, sy=0.05)
    # element row centers in y; charred (tau=0) above y=0.03, virgin below
    yc = mesh.vertices[mesh.elem_conn].mean(axis=1)[:, 1]
    tau_up = np.clip((0.03 - yc) / 0.01 + 0.5, 0.0, 1.0)  # rises with depth
    d98 = front_depth(mesh, tau_up, 0.005, 0.05, 0.0, 0.98)
    d02 = front_depth(mesh, tau_up, 0.005, 0.05, 0.0, 0.02)
    # tau crosses 0.98 deeper (smaller y) than 0.02
    assert d98 > d02 > 0.0
    assert abs((0.05 - d98) - (0.03 - 0.0048)) < 5e-3
    assert abs((0.05 - d02) - (0.03 + 0.0048)) < 5e-3
    # decreasing orientation (the reference's only detected case) still works
    d = front_depth(mesh, 1.0 - tau_up, 0.005, 0.05, 0.0, 0.5)
    assert abs((0.05 - d) - 0.03) < 5e-3
    # constant field: no front
    assert front_depth(mesh, np.ones_like(tau_up), 0.005, 0.05, 0.0,
                       0.98) == 0.0
