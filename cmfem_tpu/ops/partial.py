"""Matrix-free partial assembly: y = T^T (B^T D B) T u per element batch.

- **Transposed layout**: all per-element data is (rows, ne) with the element
  batch as the minor dimension, so every elementwise op is vectorized over
  elements and the interpolation matmuls have the huge dimension as N.
- **Lattice gather/scatter** (structured meshes): with lattice DOF
  numbering, the E-vector gather is (p+1)^3 strided slices and the
  transpose-scatter is (p+1)^3 *disjoint* strided adds, in place of a
  scalar gather and segment_sum.
- **B^T D B**: U = BG u_e, V = D U, y_e = BG^T V as two matmuls around a
  pointwise block product, left to XLA to fuse; matmuls run at
  Precision.HIGHEST (true f32 in float32).

The generic unstructured path (gather + segment_sum) remains available for
arbitrary meshes; reference parity solves use it in f64.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .assembly import SpaceOps, OperatorData
from ..core.reference_elements import get_reference_element, HEXAHEDRON


def pack_qp_blocks_T(ops: SpaceOps, data: OperatorData, dtype=jnp.float32,
                     local_perm: np.ndarray | None = None):
    """Pack OperatorData into transposed layout.

    Returns (Dflat (m*m, nq, ne), BG (nq*m, ndof)) with BG stacked m-major
    ([B; Gx; Gy; Gz]) and columns optionally permuted to `local_perm`
    (lattice local ordering for the structured fast path)."""
    ne, nq = ops.gf.wdetJ.shape
    dim = ops.G.shape[-1]
    m = 1 + dim
    blocks = []
    zeros = jnp.zeros((ne, nq), dtype=dtype)
    for r in range(m):
        for s in range(m):
            if r == 0 and s == 0:
                v = data.d00
            elif r == 0:
                v = None if data.d01 is None else data.d01[..., s - 1]
            elif s == 0:
                v = None if data.d10 is None else data.d10[..., r - 1]
            else:
                v = None if data.d11 is None else data.d11[..., r - 1, s - 1]
            blocks.append(zeros if v is None else v.astype(dtype))
    # (m*m, nq, ne)
    Dflat = jnp.stack([b.T for b in blocks], axis=0)
    B = np.asarray(ops.B)
    G = np.asarray(ops.G)
    BG = np.concatenate([B[None], np.moveaxis(G, 2, 0)], axis=0)  # (m, nq, nd)
    BG = BG.reshape(m * nq, B.shape[1])
    if local_perm is not None:
        BG = BG[:, local_perm]
    return Dflat, jnp.asarray(BG, dtype=dtype)


def _xla_btdb(BG: np.ndarray, nq: int, m: int, dtype=jnp.float32):
    """B^T D B element-batch apply in transposed layout.

    apply(u_eT (nd, ne), Dflat (m*m, nq, ne)) -> y_eT (nd, ne)."""
    HI = jax.lax.Precision.HIGHEST
    BGj = jnp.asarray(BG, dtype)

    def apply_fn(u_eT, Dflat):
        U = jnp.dot(BGj, u_eT, precision=HI)  # (nqm, ne)
        rows = []
        for r in range(m):
            Vr = None
            for s in range(m):
                t = Dflat[r * m + s] * U[s * nq:(s + 1) * nq]
                Vr = t if Vr is None else Vr + t
            rows.append(Vr)
        V = jnp.concatenate(rows, axis=0)
        return jnp.dot(BGj.T, V, precision=HI)

    return apply_fn


class PAOperator:
    """Matrix-free operator for an arbitrary (unstructured) mesh.

    Gather/scatter via u[eldofs] / segment_sum; compute via the
    transposed-layout B^T D B apply."""

    def __init__(self, ops: SpaceOps, data: OperatorData, dtype=jnp.float32):
        self.ops = ops
        self.dtype = dtype
        self.nscalar = ops.fes.nscalar
        ne, nq = ops.gf.wdetJ.shape
        dim = ops.G.shape[-1]
        self.m = 1 + dim
        self.nq = nq
        self.Dflat, BG = pack_qp_blocks_T(ops, data, dtype)
        self.eldofs = jnp.asarray(ops.fes.element_dofs)
        self._apply = _xla_btdb(np.asarray(BG), nq, self.m, dtype)

    def bind(self):
        """Return (fn(u, Dflat, eldofs) -> y, Dflat, eldofs).

        Pass the arrays through jit arguments: capturing multi-hundred-MB
        constants in a jit closure embeds them in the compiled
        executable."""
        nscalar = self.nscalar
        apply_ = self._apply
        dtype = self.dtype

        def fn(u, Dflat, eldofs):
            u_eT = u.astype(dtype)[eldofs].T
            y_eT = apply_(u_eT, Dflat)
            return jax.ops.segment_sum(
                y_eT.T.reshape(-1), eldofs.reshape(-1), num_segments=nscalar)

        return fn, self.Dflat, self.eldofs

    def __call__(self, u):
        fn, Dflat, eldofs = self.bind()
        return fn(u, Dflat, eldofs)


class StructuredGrid3D:
    """Lattice DOF numbering for an (nx, ny, nz) hex grid at order p.

    DOF (i, j, k) -> k*NY*NX + j*NX + i with N* = n*p + 1; element
    (i, j, k) -> (k*ny + j)*nx + i (the ordering of
    ``make_cartesian_mesh_3d``).  Gather is (p+1)^3 strided slices;
    scatter is (p+1)^3 disjoint strided adds."""

    def __init__(self, nx: int, ny: int, nz: int, p: int):
        self.n = (nx, ny, nz)
        self.p = p
        self.NX, self.NY, self.NZ = nx * p + 1, ny * p + 1, nz * p + 1
        self.ndofs = self.NX * self.NY * self.NZ
        self.ne = nx * ny * nz
        self.offsets = [(a, b, c)
                        for c in range(p + 1)
                        for b in range(p + 1)
                        for a in range(p + 1)]
        # permutation: entity-ordered local dof -> lattice local index
        ref = get_reference_element(HEXAHEDRON, p)
        ti = ref._tensor_idx  # (nd, 3) (i, j, k)
        lattice_lin = (ti[:, 2] * (p + 1) + ti[:, 1]) * (p + 1) + ti[:, 0]
        # local_perm[lattice_idx] = entity_idx
        self.local_perm = np.argsort(lattice_lin)

    def _slices(self, a, b, c):
        p = self.p
        nx, ny, nz = self.n
        return (slice(c, c + p * (nz - 1) + 1, p),
                slice(b, b + p * (ny - 1) + 1, p),
                slice(a, a + p * (nx - 1) + 1, p))

    def gather(self, u):
        u3 = u.reshape(self.NZ, self.NY, self.NX)
        slabs = [u3[self._slices(a, b, c)].reshape(self.ne)
                 for (a, b, c) in self.offsets]
        return jnp.stack(slabs, axis=0)  # (nd, ne) lattice-local order

    def scatter(self, y_eT):
        nx, ny, nz = self.n
        y3 = jnp.zeros((self.NZ, self.NY, self.NX), y_eT.dtype)
        for idx, (a, b, c) in enumerate(self.offsets):
            y3 = y3.at[self._slices(a, b, c)].add(
                y_eT[idx].reshape(nz, ny, nx))
        return y3.reshape(-1)

    def lattice_index(self, pos) -> np.ndarray:
        """Lattice DOF index of each entity-numbered DOF from its node
        position on the unit cube.

        Per-axis indices come from rank within the sorted unique coordinate
        values, NOT from rounding to a uniform grid: Gauss-Lobatto interior
        nodes are non-uniform, and uniform rounding collides from order 7
        up."""
        pos = np.asarray(pos)

        def axis_index(x, nx):
            xr = np.round(x, 12)
            u = np.unique(xr)
            if len(u) != nx:
                raise ValueError(
                    f"lattice recovery found {len(u)} distinct coordinates "
                    f"for a {nx}-node axis")
            return np.searchsorted(u, xr)

        lat = (axis_index(pos[:, 2], self.NZ) * self.NY
               + axis_index(pos[:, 1], self.NY)) * self.NX \
            + axis_index(pos[:, 0], self.NX)
        if len(np.unique(lat)) != self.ndofs:
            raise ValueError("node positions do not form a full lattice")
        return lat

    def boundary_mask(self):
        """Boolean (ndofs,) mask of lattice-boundary DOFs."""
        k, j, i = np.meshgrid(np.arange(self.NZ), np.arange(self.NY),
                              np.arange(self.NX), indexing="ij")
        on = ((i == 0) | (i == self.NX - 1) | (j == 0) | (j == self.NY - 1)
              | (k == 0) | (k == self.NZ - 1))
        return on.reshape(-1)

    def node_positions(self, sx=1.0, sy=1.0, sz=1.0):
        xs = np.linspace(0, sx, self.NX)
        ys = np.linspace(0, sy, self.NY)
        zs = np.linspace(0, sz, self.NZ)
        Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
        return np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=1)


class StructuredPAOperator:
    """Lattice gather/scatter + the B^T D B element-batch apply.

    Built from a SpaceOps on a ``make_cartesian_mesh_3d`` mesh; the
    operator acts on lattice-numbered DOF vectors (use `grid` helpers for
    BCs / interpolation)."""

    def __init__(self, ops: SpaceOps, data: OperatorData,
                 grid: StructuredGrid3D, dtype=jnp.float32):
        self.grid = grid
        self.dtype = dtype
        nq = ops.gf.wdetJ.shape[1]
        dim = ops.G.shape[-1]
        self.m = 1 + dim
        self.Dflat, BG = pack_qp_blocks_T(ops, data, dtype,
                                          local_perm=grid.local_perm)
        self._apply = _xla_btdb(np.asarray(BG), nq, self.m, dtype)

    def bind(self):
        """Return (fn(u, Dflat) -> y, Dflat); see PAOperator.bind."""
        grid = self.grid
        apply_ = self._apply
        dtype = self.dtype

        def fn(u, Dflat):
            u_eT = grid.gather(u.astype(dtype))
            y_eT = apply_(u_eT, Dflat)
            return grid.scatter(y_eT)

        return fn, self.Dflat

    def __call__(self, u):
        fn, Dflat = self.bind()
        return fn(u, Dflat)
