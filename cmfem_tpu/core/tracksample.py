"""Jittable point sampling on a receding mesh (tracked candidates).

The 2.2 scan driver needs per-step probe/front/mass-probe sampling, but
``locate_points`` is a host function and calling it per step costs a
host round trip per CSV stream (larger than the whole device step).
The physical probe points
are FIXED and the production recession moves vertices vertically by at
most a few mm, so the set of elements that can ever contain a point is
a small static candidate list: precompute (point, element) candidate
pairs from the initial geometry with a vertical slack band, and per
step redo only a tiny batched barycentric test against the CURRENT
vertices — entirely inside the compiled scan step.

Reference analog: the per-step ParMesh::FindPoints sampling of the 2.2
driver (ablation_test_case2_2_2D.cpp:3148-3273, probe/mass/front CSVs);
semantics (NaN where not found, lowest-element-id donor) match
``core.pointlocate``'s host versions, tested against them.

Order-1 triangle meshes only — the production scan paths' regime.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .mesh import Mesh
from .reference_elements import TRIANGLE


class TrackedSampler:
    """Precomputed candidate-pair point locator for fixed physical
    points on a moving-vertex triangle mesh.

    ``y_slack`` widens each element's candidate bbox vertically; it must
    cover the TOTAL mesh motion over the run (the production 2.2 deck
    recedes ~5.1 mm over 120 s).
    Derive it from a recession bound (max_step_recession * nsteps,
    capped at the strip height) rather than a fixed heuristic: a band
    smaller than the realized motion silently turns probe/front samples
    NaN once the surface recedes past it."""

    def __init__(self, mesh: Mesh, points, y_slack: float = 0.01,
                 tol: float = 1e-9):
        if mesh.geom != TRIANGLE:
            raise NotImplementedError(
                "TrackedSampler supports order-1 triangle meshes")
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        verts0 = np.asarray(mesh.vertices)
        conn = np.asarray(mesh.elem_conn)
        coords = verts0[conn]                      # (ne, 3, 2)
        lo = coords.min(axis=1)
        hi = coords.max(axis=1)
        lo[:, 1] -= y_slack
        hi[:, 1] += y_slack
        lo -= tol
        hi += tol
        inside = ((pts[:, None, :] >= lo[None]) &
                  (pts[:, None, :] <= hi[None])).all(axis=2)
        ip, ie = np.nonzero(inside)                # sorted by (point, elem)
        self.npts = len(pts)
        self.npairs = len(ip)
        self.ip = jnp.asarray(ip)
        self.ie = jnp.asarray(ie)
        self.pair_conn = jnp.asarray(conn[ie])     # (npairs, 3)
        self.pts = jnp.asarray(pts)
        self.conn = jnp.asarray(conn)
        self.tol = float(tol)

    # -- location (jittable) --------------------------------------------

    def locate(self, verts, pts=None):
        """(eid (npts,) int32 [-1 when not found], ref (npts, 2),
        found (npts,) bool) against the CURRENT vertices.  Donor choice
        is the lowest containing element id — the host
        ``locate_points`` order.

        ``pts`` optionally overrides the query positions (same count and
        order as construction) — e.g. a wall probe whose y tracks the
        receding surface; overridden points must stay within the
        construction points' slack band for the candidate list to remain
        valid."""
        eps = 1e-9
        qpts = self.pts if pts is None else pts
        v = verts[self.pair_conn]                  # (npairs, 3, 2)
        v0 = v[:, 0]
        a = v[:, 1] - v0
        b = v[:, 2] - v0
        det = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
        rhs = qpts[self.ip] - v0
        ok = jnp.abs(det) > 1e-30
        inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
        r0 = (b[:, 1] * rhs[:, 0] - b[:, 0] * rhs[:, 1]) * inv
        r1 = (-a[:, 1] * rhs[:, 0] + a[:, 0] * rhs[:, 1]) * inv
        ins = ok & (r0 >= -eps) & (r1 >= -eps) & (r0 + r1 <= 1.0 + eps)
        BIG = jnp.asarray(np.iinfo(np.int32).max, jnp.int32)
        key = jnp.where(ins, self.ie.astype(jnp.int32), BIG)
        eid = jnp.full(self.npts, BIG, jnp.int32).at[self.ip].min(key)
        found = eid < BIG
        # exactly one pair per point satisfies (ins & ie == eid[ip])
        chosen = ins & (self.ie.astype(jnp.int32) == eid[self.ip])
        ref = jnp.zeros((self.npts, 2), verts.dtype).at[self.ip].add(
            jnp.where(chosen[:, None], jnp.stack([r0, r1], axis=1), 0.0))
        return jnp.where(found, eid, -1), ref, found

    # -- sampling (jittable; compose with one locate per step) ----------

    def sample_h1(self, loc, u):
        """P1 nodal interpolation of ``u`` (n,) at the located points;
        NaN where not found."""
        eid, ref, found = loc
        dofs = self.conn[jnp.maximum(eid, 0)]      # (npts, 3)
        un = u[dofs]
        val = (un[:, 0] * (1.0 - ref[:, 0] - ref[:, 1])
               + un[:, 1] * ref[:, 0] + un[:, 2] * ref[:, 1])
        return jnp.where(found, val, jnp.nan)

    def sample_grad(self, loc, u, verts):
        """Physical gradient of a P1 field at the located points
        (constant per triangle): (npts, 2), NaN rows where not found."""
        eid, ref, found = loc
        tri = self.conn[jnp.maximum(eid, 0)]
        v = verts[tri]                             # (npts, 3, 2)
        a = v[:, 1] - v[:, 0]
        b = v[:, 2] - v[:, 0]
        det = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
        ok = jnp.abs(det) > 1e-30
        inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
        un = u[tri]
        du1 = un[:, 1] - un[:, 0]
        du2 = un[:, 2] - un[:, 0]
        # grad = A^-T [du1, du2]; A = [a b] columns
        gx = (b[:, 1] * du1 - a[:, 1] * du2) * inv
        gy = (-b[:, 0] * du1 + a[:, 0] * du2) * inv
        g = jnp.stack([gx, gy], axis=1)
        return jnp.where(found[:, None], g, jnp.nan)

    def sample_l2(self, loc, elem_vals):
        """Per-element (L2(0)) field at the located points; NaN where
        not found."""
        eid, _, found = loc
        return jnp.where(found, elem_vals[jnp.maximum(eid, 0)], jnp.nan)


def line_points(x, y_top, y_bottom, ns: int = 250):
    """The ``front_depth`` sampling line: ns+1 points from just below
    y_top down to just above y_bottom at fixed x (host front_depth's
    grid, core/pointlocate.py)."""
    eps = 1e-9
    y0 = y_top - eps
    y1 = y_bottom + eps
    ys = y0 - np.arange(ns + 1) * (y0 - y1) / ns
    return np.stack([np.full(ns + 1, x), ys], axis=1)


def front_depth_from_samples(vals, ys, y_top, threshold):
    """Jittable crossing detection matching host ``front_depth``:
    depth below ``y_top`` of the first finite-pair threshold crossing
    (either direction) along the sampled line, else 0.0.

    ``vals``/``ys`` are the line samples ordered top->bottom; ``y_top``
    is the CURRENT surface height (samples above it are NaN = skipped,
    so a receded-away prefix never produces a crossing)."""
    vp = vals[:-1]
    vc = vals[1:]
    fin = jnp.isfinite(vp) & jnp.isfinite(vc)
    crossing = fin & (((vp > threshold) & (vc <= threshold))
                      | ((vp < threshold) & (vc >= threshold)))
    k = jnp.argmax(crossing)                      # first True (0 if none)
    any_ = jnp.any(crossing)
    vpk = vp[k]
    vck = vc[k]
    denom = vpk - vck
    frac = jnp.where(jnp.abs(denom) < 1e-14, 0.0,
                     jnp.clip((vpk - threshold) / denom, 0.0, 1.0))
    y_cross = ys[k] - frac * (ys[k] - ys[k + 1])
    depth = jnp.maximum(0.0, y_top - y_cross)
    return jnp.where(any_, depth, 0.0)
