"""Global sum-factorized operator apply for structured hex grids.

The fast path for the 3D operator apply.  Per-element gather/scatter is
removed entirely: with a tensor-product grid, interpolation of values and
gradients to ALL quadrature points is three axis-wise dense matmuls applied
to the 3D DOF lattice (spectral-element sum factorization, operating on the
global tensor product rather than per element):

    V   = Az (x) Ay (x) Ax  u3          (values at every QP)
    Gx  = Az (x) Ay (x) DAx u3          (reference x-gradients), etc.

where A/DA are ((n_elem * nq1d), ndof1d) block-banded 1D interpolation
matrices.  The QP operator blocks D are pre-permuted (static) into the
same QP-lattice layout, the 4x4 block action is pointwise, and the
transposed chains assemble y3 directly -- matmuls and elementwise ops only,
no scatter.  All matmuls run at Precision.HIGHEST (true f32, no TF32;
0/1-structured operands make the selection exact).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .assembly import SpaceOps, OperatorData
from ..core.quadrature import _gauss_1d
from ..core.reference_elements import gauss_lobatto_nodes
from .partial import pack_qp_blocks_T

HI = jax.lax.Precision.HIGHEST


def _lagrange_tab_1d(p: int, q1: int):
    """1D basis values/derivatives at q1 Gauss points: (q1, p+1) each."""
    from ..core.reference_elements import _lagrange_1d

    nodes = gauss_lobatto_nodes(p)
    x, w = _gauss_1d(q1)
    B, G = _lagrange_1d(nodes, x)
    return B, G, w


def _axis_matrices(n_el: int, p: int, q1: int):
    """Block-banded (n_el*q1, n_el*p+1) interpolation + derivative matrices."""
    B, G, _ = _lagrange_tab_1d(p, q1)
    N = n_el * p + 1
    A = np.zeros((n_el * q1, N))
    DA = np.zeros((n_el * q1, N))
    for e in range(n_el):
        for q in range(q1):
            A[e * q1 + q, e * p:e * p + p + 1] = B[q]
            DA[e * q1 + q, e * p:e * p + p + 1] = G[q]
    return A, DA


class SumFactoredOperator:
    """Matrix-free structured-grid operator with zero gather/scatter.

    Built from a SpaceOps/OperatorData pair on a ``make_cartesian_mesh_3d``
    mesh; acts on lattice-numbered DOF vectors (same numbering as
    StructuredGrid3D)."""

    def __init__(self, ops: SpaceOps, data: OperatorData, nx, ny, nz,
                 order: int, dtype=jnp.float32):
        self.dtype = dtype
        p = order
        quad = ops.quad
        q1 = round(len(quad.weights) ** (1 / 3))
        assert q1**3 == len(quad.weights), "expects a tensor quadrature rule"
        self.n = (nx, ny, nz)
        self.q1 = q1
        self.p = p
        self.NX, self.NY, self.NZ = nx * p + 1, ny * p + 1, nz * p + 1
        self.ndofs = self.NX * self.NY * self.NZ

        Ax, DAx = _axis_matrices(nx, p, q1)
        Ay, DAy = _axis_matrices(ny, p, q1)
        Az, DAz = _axis_matrices(nz, p, q1)
        self.Ax = jnp.asarray(Ax, dtype)
        self.DAx = jnp.asarray(DAx, dtype)
        self.Ay = jnp.asarray(Ay, dtype)
        self.DAy = jnp.asarray(DAy, dtype)
        self.Az = jnp.asarray(Az, dtype)
        self.DAz = jnp.asarray(DAz, dtype)

        # permute D blocks from (m*m, nq, ne) [q z-major, e (k,j,i)-major]
        # to the QP lattice (Kz, Ky, Kx) with K* = n* x q1.
        # Structure-aware compression: when the grad-grad block is symmetric
        # and there is no grad-test/value-trial coupling (true for
        # mass+diffusion+convection), only 10 of the 16 planes are stored —
        # D traffic is the bandwidth floor of this operator.
        Dflat, _ = pack_qp_blocks_T(ops, data, dtype)
        mm, nq, ne = Dflat.shape
        self.m = int(round(np.sqrt(mm)))
        m = self.m
        Dnp = np.asarray(Dflat)
        sym = all(
            np.allclose(Dnp[r * m + s_], Dnp[s_ * m + r], rtol=1e-12, atol=0)
            for r in range(1, m) for s_ in range(r + 1, m))
        no_d10 = all(not np.any(Dnp[r * m]) for r in range(1, m))
        self.compressed = bool(sym and no_d10)
        if self.compressed:
            # plane order: D00, D0x, D0y, D0z, Dxx, Dxy, Dxz, Dyy, Dyz, Dzz
            planes = [Dnp[0]]
            planes += [Dnp[s_] for s_ in range(1, m)]
            self._pairs = []
            for r in range(1, m):
                for s_ in range(r, m):
                    planes.append(Dnp[(r) * m + s_])
                    self._pairs.append((r, s_))
            Dnp = np.stack(planes, axis=0)
            mm = Dnp.shape[0]
            Dflat = jnp.asarray(Dnp)
        qz, qy, qx = np.meshgrid(np.arange(q1), np.arange(q1), np.arange(q1),
                                 indexing="ij")
        k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                              indexing="ij")
        # flat (q, e) index for every lattice point
        q_idx = (qz * q1 + qy) * q1 + qx  # (q1,q1,q1)
        e_idx = (k * ny + j) * nx + i     # (nz,ny,nx)
        lat_q = np.zeros((nz * q1, ny * q1, nx * q1), dtype=np.int64)
        lat_e = np.zeros_like(lat_q)
        for kk in range(nz):
            for jj in range(ny):
                for ii in range(nx):
                    lat_q[kk * q1:(kk + 1) * q1, jj * q1:(jj + 1) * q1,
                          ii * q1:(ii + 1) * q1] = q_idx
                    lat_e[kk * q1:(kk + 1) * q1, jj * q1:(jj + 1) * q1,
                          ii * q1:(ii + 1) * q1] = e_idx[kk, jj, ii]
        flat = (lat_q * ne + lat_e).reshape(-1)
        Dl = np.asarray(Dflat).reshape(mm, nq * ne)[:, flat]
        self.Kz, self.Ky, self.Kx = nz * q1, ny * q1, nx * q1
        self.D = jnp.asarray(Dl.reshape(mm, self.Kz, self.Ky, self.Kx), dtype)
        # element-periodic D (uniform grid + element-independent
        # coefficients): every element's QP block is identical, so the
        # lattice D is a (q1, q1, q1) pattern tiled ne times.
        Dl4 = np.asarray(self.D)
        # Element-to-element variation below the geometric-factor rounding
        # floor counts as uniform: O(1) coordinates differenced into O(1/n)
        # elements lose a factor max(n) of relative precision, so the floor
        # is eps * max(n) * max|D|, capped at 1e-5 * max|D| so that real
        # (if weak) coefficient variation on very large grids is never
        # classified as uniform.  NOTE the detection cannot distinguish
        # genuine sub-floor coefficient variation from rounding noise --
        # bind(use_periodic=True) is an explicit assertion by the caller
        # that the operator is uniform along the tiled axes.
        tol = min(4 * np.finfo(Dl4.dtype).eps * max(nx, ny, nz), 1e-5) \
            * np.abs(Dl4).max()
        # self.periodic is a diagnostic only (full (q1,q1,q1) uniformity);
        # the apply consumes the z-only pattern below.
        D7 = Dl4.reshape(mm, nz, q1, ny, q1, nx, q1).astype(np.float64)
        Dsmall = D7.mean(axis=(1, 3, 5)).astype(Dl4.dtype)  # noise-averaged
        self.periodic = bool(
            np.abs(Dl4 - np.tile(Dsmall, (1, nz, ny, nx))).max() <= tol)
        # z-only periodicity (weaker: uniform z-extrusion with possibly
        # xy-varying coefficients), stored as (mm, q1, Ky, Kx): the apply
        # broadcasts it along a leading element-z axis, so D's device
        # memory traffic drops by the factor nz.
        D5 = Dl4.reshape(mm, nz, q1, self.Ky, self.Kx).astype(np.float64)
        Dz = D5.mean(axis=1).astype(Dl4.dtype)
        self.z_periodic = bool(
            np.abs(Dl4 - np.tile(Dz, (1, nz, 1, 1))
                   .reshape(Dl4.shape)).max() <= tol)
        self.Dz = jnp.asarray(Dz, dtype) if self.z_periodic else None

    def bind(self, use_periodic: bool = False):
        """(fn(u, D) -> y, D) with all big arrays as jit args.

        use_periodic replaces the full lattice D with the z-periodic
        (mm, q1, Ky, Kx) pattern (requires ``self.z_periodic`` and the
        compressed packing): the quadrature fields are viewed as
        (nz, q1, Ky, Kx) so the pattern broadcasts along the leading z
        axis inside the elementwise multiply, and only q1 z-planes of D
        are read per apply instead of Kz."""
        if use_periodic and not (self.z_periodic and self.compressed):
            raise ValueError(
                "periodic sumfact path requires z-periodic compressed "
                "D (uniform z-extrusion, z-uniform coefficients)")
        Ax, DAx = self.Ax, self.DAx
        Ay, DAy = self.Ay, self.DAy
        Az, DAz = self.Az, self.DAz
        NX, NY, NZ = self.NX, self.NY, self.NZ
        Kz, Ky, Kx = self.Kz, self.Ky, self.Kx
        m = self.m
        if use_periodic:
            qp_shape = (self.n[2], self.q1, Ky, Kx)
            plane = lambda D, i: D[i][None]
        else:
            qp_shape = (Kz, Ky, Kx)
            plane = lambda D, i: D[i]

        def fwd(u3, Mx, My, Mz):
            # contract each axis in turn: (NZ,NY,NX) -> (Kz,Ky,Kx)
            t = jnp.einsum("ax,zyx->zya", Mx, u3, precision=HI)
            t = jnp.einsum("by,zya->zba", My, t, precision=HI)
            t = jnp.einsum("cz,zba->cba", Mz, t, precision=HI)
            return t.reshape(qp_shape)

        def bwd(w, Mx, My, Mz):
            t = jnp.einsum("cz,cba->zba", Mz, w.reshape(Kz, Ky, Kx),
                           precision=HI)
            t = jnp.einsum("by,zba->zya", My, t, precision=HI)
            return jnp.einsum("ax,zya->zyx", Mx, t, precision=HI)

        def fn(u, D):
            u3 = u.astype(self.dtype).reshape(NZ, NY, NX)
            V = [
                fwd(u3, Ax, Ay, Az),     # values
                fwd(u3, DAx, Ay, Az),    # d/dxi_x
                fwd(u3, Ax, DAy, Az),    # d/dxi_y
                fwd(u3, Ax, Ay, DAz),    # d/dxi_z
            ]
            pl = lambda i: plane(D, i)
            if self.compressed:
                # planes: [D00, D0x.., upper-tri Dss]; d10 = 0; Dss symmetric
                W = [pl(0) * V[0]]
                for s in range(1, m):
                    W[0] = W[0] + pl(s) * V[s]
                Wg = [None] * (m - 1)
                for k, (r, s) in enumerate(self._pairs):
                    t = pl(m + k) * V[s]
                    Wg[r - 1] = t if Wg[r - 1] is None else Wg[r - 1] + t
                    if s != r:
                        t2 = pl(m + k) * V[r]
                        Wg[s - 1] = t2 if Wg[s - 1] is None \
                            else Wg[s - 1] + t2
                W += Wg
            else:
                W = []
                for r in range(m):
                    acc = None
                    for s in range(m):
                        t = pl(r * m + s) * V[s]
                        acc = t if acc is None else acc + t
                    W.append(acc)
            y3 = bwd(W[0], Ax, Ay, Az)
            y3 = y3 + bwd(W[1], DAx, Ay, Az)
            y3 = y3 + bwd(W[2], Ax, DAy, Az)
            y3 = y3 + bwd(W[3], Ax, Ay, DAz)
            return y3.reshape(-1)

        return fn, (self.Dz if use_periodic else self.D)

    def best_bind(self):
        """(fn, D_arg): the faster of the two apply paths.

        The z-periodic path reads nz times less of D; measured on an
        H100 80GB HBM3 (700 W) it is 4-6% faster than the plain chain at
        orders 2, 3 and 4, from 0.9M to 11.4M DOFs (PERF.md).  It
        applies only to a z-periodic, compressed operator; anything else
        takes the plain ``bind()``."""
        return self.bind(use_periodic=self.z_periodic and self.compressed)

    def min_bytes(self, periodic: bool = False) -> int:
        """Least device-memory traffic of one apply: read D (or its
        z-periodic pattern) and u, write y.  Quadrature-point fields are
        counted as never leaving the chip, so achieved bytes/s from this
        model is a lower bound on the true traffic rate."""
        D = self.Dz if periodic else self.D
        return int(D.size * D.dtype.itemsize
                   + 2 * self.ndofs * np.dtype(self.dtype).itemsize)

    def __call__(self, u):
        fn, D = self.bind()
        return fn(u, D)
