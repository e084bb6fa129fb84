"""Window-slicing gather/scatter for tensor-product 2D dof lattices.

Per-element gather (``u[eldofs]``) and segment-sum scatter are
data-dependent memory accesses in the coupled ablation residual.  On the
reference's tensor-product strip meshes (Mesh/ablation_strip.geo) the
element dof pattern is a fixed lattice stencil, so

- gather  = ``nd`` static window slices of the (NY, NX) dof lattice, and
- scatter = ``nd`` shifted ``.at[window].add`` overlap-adds,

exactly the trick ``solvers/blocksolve.py`` already plays for the GMRES
matvec (stencil/DIA mode) and ``ops/sumfact.py`` plays in 3D.  This
module packages it for residual-style element kernels.

The plan requires mesh elements to be ordered row-major over the cell
lattice (true for ``make_cartesian_mesh_2d``; GMSH strips can be
renumbered with ``Mesh`` element reordering) — it raises otherwise, and
callers fall back to the generic gather/scatter path.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


class StripLatticeOps:
    """Gather/scatter/interp over a (NY, NX) tensor-product dof lattice.

    Parameters
    ----------
    element_dofs : (ne, nd) scalar-space element dof map.
    n            : scalar dof count.
    lat          : (NY, NX) dof-id lattice (``strip_dof_lattice``).

    Raises ValueError when the elements are not a uniform row-major cell
    lattice over ``lat`` (caller should fall back to the generic path).
    """

    def __init__(self, element_dofs, n, lat):
        ed = np.asarray(element_dofs, dtype=np.int64)
        lat = np.asarray(lat, dtype=np.int64)
        NY, NX = lat.shape
        ne, nd = ed.shape
        if NY * NX != int(n):
            raise ValueError("lattice must enumerate every scalar dof")
        perm = np.empty(int(n), np.int64)
        perm[lat.reshape(-1)] = np.arange(int(n))
        ly, lx = perm[ed] // NX, perm[ed] % NX      # (ne, nd)
        ey, ex = ly.min(axis=1), lx.min(axis=1)
        oy, ox = ly - ey[:, None], lx - ex[:, None]
        if not ((oy == oy[0]).all() and (ox == ox[0]).all()):
            raise ValueError("elements do not share one lattice dof stencil")
        py, px = int(oy[0].max()), int(ox[0].max())
        if py == 0 or px == 0 or (NY - 1) % py or (NX - 1) % px:
            raise ValueError("element stencil does not tile the lattice")
        nyc, nxc = (NY - 1) // py, (NX - 1) // px
        if ne != nyc * nxc:
            raise ValueError("element count does not match the cell lattice")
        if ey.max() + py != NY - 1 or ex.max() + px != NX - 1:
            raise ValueError("element cells do not cover the lattice")
        cell = (ey // py) * nxc + (ex // px)
        if not (cell == np.arange(ne)).all():
            raise ValueError(
                "mesh elements are not row-major over the cell lattice; "
                "renumber elements (argsort by cell) to enable this path")
        self.NY, self.NX = NY, NX
        self.nyc, self.nxc = nyc, nxc
        self.ne, self.nd = ne, nd
        self.n = int(n)
        self.offs = [(int(a), int(b)) for a, b in zip(oy[0], ox[0])]
        self.latflat = jnp.asarray(lat.reshape(-1))
        self.dofperm = jnp.asarray(perm)

    # -- lattice <-> dof order ----------------------------------------------

    def to_lat(self, u):
        """dof-ordered (n,) -> (NY, NX) lattice field (one gather)."""
        return u[self.latflat].reshape(self.NY, self.NX)

    def from_lat(self, ul):
        """(NY, NX) lattice field -> dof-ordered (n,) (one gather)."""
        return ul.reshape(-1)[self.dofperm]

    # -- element-window access ------------------------------------------------

    def windows(self, ul):
        """(NY, NX) -> list of nd (nyc, nxc) element-corner windows: entry
        ``a`` holds local dof ``a`` of every element, row-major cells."""
        py = (self.NY - 1) // self.nyc
        px = (self.NX - 1) // self.nxc
        return [ul[oy::py, ox::px][:self.nyc, :self.nxc]
                for (oy, ox) in self.offs]

    def gather_elem(self, ul):
        """(NY, NX) lattice field -> (ne, nd) element dof values without a
        gather (stack of static strided windows)."""
        return jnp.stack([w.reshape(-1) for w in self.windows(ul)], axis=1)

    def interp(self, ul, B):
        """Element-interior interpolation: lattice field (NY, NX) with a
        (nq, nd) tabulation -> (ne, nq) QP values, windows-and-FMA only.
        The tabulation must be concrete (static basis values); it is
        baked into the program as compile-time FMA weights."""
        Bn = np.asarray(B)
        ws = self.windows(ul)
        cols = []
        for q in range(Bn.shape[0]):
            acc = float(Bn[q, 0]) * ws[0]
            for a in range(1, self.nd):
                acc = acc + float(Bn[q, a]) * ws[a]
            cols.append(acc.reshape(-1))
        return jnp.stack(cols, axis=1)              # (ne, nq)

    def add_window(self, dst, vals, a):
        """dst (..., NY, NX) += vals (..., nyc, nxc) scattered to local-dof
        window ``a`` (the shared overlap-add used by scatter() and the
        block solver's stencil assembly)."""
        py = (self.NY - 1) // self.nyc
        px = (self.NX - 1) // self.nxc
        oy, ox = self.offs[a]
        pads = [(0, 0)] * (vals.ndim - 2) + [
            (0, (self.NY - oy + py - 1) // py - self.nyc),
            (0, (self.NX - ox + px - 1) // px - self.nxc)]
        return dst.at[..., oy::py, ox::px].add(jnp.pad(vals, pads))

    def scatter(self, y_e):
        """(ne, nd) element contributions -> dof-ordered (n,) via nd
        shifted overlap-adds (no segment_sum)."""
        ycells = y_e.reshape(self.nyc, self.nxc, self.nd)
        yl = jnp.zeros((self.NY, self.NX), y_e.dtype)
        for a in range(self.nd):
            yl = self.add_window(yl, ycells[:, :, a], a)
        return self.from_lat(yl)


def cluster_x_columns(vals, tol_factor=1e-8):
    """Tolerance-walk clustering of 1D coordinates into columns: returns
    (col_index_per_val, ncols).  The single home of the GMSH float-jitter
    tolerance, shared by ``solvers.blocksolve.strip_dof_lattice`` and
    ``strip_element_order``."""
    vs = np.unique(vals)
    span = max(float(vs[-1] - vs[0]), 1e-30)
    tol = tol_factor * span
    reps = [float(vs[0])]
    for v in vs[1:]:
        if v - reps[-1] > tol:
            reps.append(float(v))
    edges = 0.5 * (np.asarray(reps[1:]) + np.asarray(reps[:-1]))
    return np.searchsorted(edges, vals), len(reps)


def strip_element_order(mesh):
    """Row-major (y-outer, x-inner) element permutation for a 2D
    tensor-product strip mesh, from tolerance-clustered element centroids
    (same clustering as ``solvers.blocksolve.strip_dof_lattice``).
    Returns ``order`` with ``elem_conn[order]`` row-major over cells, or
    raises ValueError when the centroids are not a full tensor grid."""
    cent = mesh.vertices[mesh.elem_conn].mean(axis=1)
    ne = len(cent)

    # x columns by tolerance walk; rows by per-column y sort — the strip
    # meshes share x columns exactly but carry per-column y jitter (848
    # distinct vertex-y values for 240 logical rows on ablation_strip.msh),
    # so y cannot be clustered globally
    cx, nxc = cluster_x_columns(cent[:, 0])
    if ne % nxc:
        raise ValueError("element centroids do not form a column lattice")
    nyc = ne // nxc
    cell = np.empty(ne, np.int64)
    for c in range(nxc):
        ids = np.nonzero(cx == c)[0]
        if len(ids) != nyc:
            raise ValueError("unequal column heights in element lattice")
        cell[ids[np.argsort(cent[ids, 1], kind="stable")]] = \
            np.arange(nyc) * nxc + c
    order = np.argsort(cell, kind="stable")
    return order


def reorder_mesh_elements(mesh, order):
    """A copy of ``mesh`` with volume elements permuted by ``order``
    (boundary faces and vertices untouched; per-element state arrays in
    callers must be built AFTER the reorder)."""
    from dataclasses import replace

    return replace(
        mesh,
        elem_conn=np.ascontiguousarray(mesh.elem_conn[order]),
        elem_attr=np.ascontiguousarray(mesh.elem_attr[order]),
    )
