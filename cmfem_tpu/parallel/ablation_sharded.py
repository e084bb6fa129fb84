"""Element-sharded ablation (T, p) Newton step over a device mesh.

Multi-device version of the flagship coupled pyrolysis solve: the
replacement for running the reference's ablation drivers under
``mpirun -np N`` (MPI domain decomposition over mesh elements +
MUMPS-backed Newton, SURVEY.md §2.4 / §3.4).  Each device owns a
contiguous slab of elements (with their per-QP reaction state and
geometric factors); T/p DOF vectors are replicated:

- **residual**: per-element quadrature work runs device-local through the
  exact same ``AblationSystem.elem_residual_fn`` closure the single-chip
  path uses, followed by a local segment-sum scatter and ONE ``psum``
  (the shared-DOF exchange);
- **Jacobian**: vmapped forward-mode AD of that closure over the local
  element slab — embarrassingly element-parallel, no communication;
- **linear solve**: the equilibrated point-block GMRES of
  ``solvers.blocksolve`` with the matvec distributed the same way
  (local batched (2nd, 2nd) block matmul + segment-sum + psum); the
  equilibration/preconditioner build reduces block diagonals with one
  psum per prepare;
- **SEB top boundary** (cases 2.1/2.2): each boundary face is assigned to
  the device owning its adjacent element, so the face flux residual and
  its AD blocks are computed and folded into the local element blocks
  with no extra communication (``seb=(branch, model, bprime)``; the
  aerothermal BoundaryState is a traced pytree argument).

Element padding (to a multiple of the device count) duplicates element 0's
DOF map with zeroed quadrature weights, so padded elements contribute
exactly zero to residuals, Jacobian blocks, and diagonal reductions; face
padding likewise carries zero face weights.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..physics.ablation import AblationSystem
from ..solvers.blocksolve import (
    equilibrated_block_factors, solve_equilibrated,
)


class ShardedAblationNewton:
    """Element-sharded residual / AD Jacobian / block-GMRES for the
    coupled (T, p) ablation system on a ``jax.sharding.Mesh``."""

    def __init__(self, system: AblationSystem, dev_mesh: Mesh, ess_T, ess_p,
                 axis: str = "dd", restart: int = 400, maxiter: int = 10,
                 seb=None, ale_toggles=(True, True, True)):
        self.sys = system
        self.mesh = dev_mesh
        self.axis = axis
        self.ale_toggles = tuple(ale_toggles)
        self.n = system.n
        self.nd = int(system.ops.eldofs.shape[1])
        self.restart = int(restart)
        self.maxiter = int(maxiter)
        self.seb = seb

        ndev = dev_mesh.devices.size
        ne = system.ne
        self.ne = ne
        self.ne_pad = ((ne + ndev - 1) // ndev) * ndev
        self._pad = self.ne_pad - ne
        epd = self.ne_pad // ndev

        mask = np.zeros(2 * self.n, dtype=bool)
        mask[np.asarray(ess_T, dtype=np.int64)] = True
        mask[np.asarray(ess_p, dtype=np.int64) + self.n] = True
        self.mask2 = jnp.asarray(mask)

        ops = system.ops
        eldofs = np.asarray(ops.eldofs, dtype=np.int64)
        invJ = np.asarray(ops.gf.invJ)
        wdetJ = np.asarray(ops.gf.wdetJ)
        if self._pad:
            eldofs = np.concatenate(
                [eldofs, np.repeat(eldofs[:1], self._pad, axis=0)])
            invJ = np.concatenate(
                [invJ, np.repeat(invJ[:1], self._pad, axis=0)])
            # zero quadrature weights null every padded-element
            # contribution (dtype preserved: a dtype-less zeros pad would
            # silently promote f32 factors to f64)
            wdetJ = np.concatenate(
                [wdetJ, np.zeros((self._pad,) + wdetJ.shape[1:],
                                 dtype=wdetJ.dtype)])
        sh = NamedSharding(dev_mesh, P(axis))
        self.eldofs = jax.device_put(eldofs, sh)
        self.invJ = jax.device_put(invJ, sh)
        self.wdetJ = jax.device_put(wdetJ, sh)
        # local essential masks over the padded element slabs
        lT = mask[:self.n][eldofs]
        lp = mask[self.n:][eldofs]
        self.lmask = jax.device_put(
            np.concatenate([lT, lp], axis=1), sh)
        self._sharding = sh

        if seb is not None:
            # assign each top-boundary face to the device that owns its
            # adjacent element; pad every device to the same face count
            # with zero-weight dummies (face 0's data, wdS = 0).  The
            # face -> device assignment is static topology: compute the
            # packed destination slots once and reuse them on every ALE
            # geometry refresh.
            tr = system.trace
            elem = np.asarray(tr.elem, dtype=np.int64)
            if len(elem) == 0:
                raise ValueError(
                    "SEB enabled but the top-boundary trace selects no "
                    "faces — check the boundary attribute")
            owner = elem // epd
            counts = np.bincount(owner, minlength=ndev)
            nfmax = max(1, int(counts.max()))
            self.nf_local = nfmax
            slot = np.zeros(len(elem), dtype=np.int64)
            for d in range(ndev):
                idx = np.nonzero(owner == d)[0]
                slot[idx] = np.arange(len(idx))
            self._face_dst = owner * nfmax + slot
            ff = tr.face_factors()
            fdata = {
                "Bf": np.asarray(tr.Btab)[tr.combo],
                "Gf": np.asarray(tr.Gtab)[tr.combo],
                "invJf": np.asarray(tr.element_invJ()),
                "nrm": np.asarray(ff.normal),
                "wdS": np.asarray(ff.wdS),
                "eldofs_f": np.asarray(tr.eldofs, dtype=np.int64),
                "elem_local": elem - owner * epd,
            }
            self._f = {k: self._pack_faces(a, zero_fill=k in
                                           ("wdS", "elem_local"))
                       for k, a in fdata.items()}

        self._residual_j = jax.jit(self._residual_impl)
        self._prepare_j = jax.jit(self._prepare_impl)
        self._solve = jax.jit(self._solve_impl)

    # -- helpers -------------------------------------------------------------

    def pad_elem(self, a):
        """Pad an (ne, ...) per-element array (duplicating element 0) and
        shard it over the device mesh."""
        a = np.asarray(a)
        if self._pad:
            a = np.concatenate([a, np.repeat(a[:1], self._pad, axis=0)])
        return jax.device_put(a, self._sharding)

    def _pad_elem_dev(self, a):
        """Device-side pad_elem (no host roundtrip): duplicate element 0
        into the pad rows and reshard — used by the per-step ALE
        geometry refresh."""
        a = jnp.asarray(a)
        if self._pad:
            a = jnp.concatenate([a, jnp.repeat(a[:1], self._pad, axis=0)])
        return jax.device_put(a, self._sharding)

    def _pack_faces(self, a, zero_fill=False):
        """Scatter a per-face array (nfaces, ...) into the padded
        per-device face slabs (ndev*nf_local, ...) and shard it.  Dummy
        slots carry face 0's data (finite, never read with weight) or
        zeros (``zero_fill`` — face weights and local element ids)."""
        a = np.asarray(a)
        ndev = self.mesh.devices.size
        shape = (ndev * self.nf_local,) + a.shape[1:]
        if zero_fill:
            out = np.zeros(shape, dtype=a.dtype)
        else:
            out = np.broadcast_to(a[:1], shape).copy()
        out[self._face_dst] = a
        return jax.device_put(out, self._sharding)

    def update_geometry(self, vertices):
        """Refresh the sharded geometric factors (and SEB face geometry)
        for moved mesh vertices — the case-2.2 ALE step.  The factor
        arrays are call-time arguments of the jitted kernels, so no
        retrace happens."""
        gf = self.sys.ops.geometric_factors(jnp.asarray(vertices))
        wdetJ = jnp.asarray(gf.wdetJ)
        if self._pad:
            # zero weights (dtype-preserving) null the pad contributions
            wdetJ = jnp.concatenate(
                [wdetJ, jnp.zeros((self._pad,) + wdetJ.shape[1:],
                                  wdetJ.dtype)])
            self.invJ = self._pad_elem_dev(gf.invJ)
        else:
            self.invJ = jax.device_put(jnp.asarray(gf.invJ),
                                       self._sharding)
        self.wdetJ = jax.device_put(wdetJ, self._sharding)
        if self.seb is not None:
            tr = self.sys.trace
            ff = tr.face_factors(vertices)
            upd = {
                "invJf": np.asarray(tr.element_invJ(vertices)),
                "nrm": np.asarray(ff.normal),
                "wdS": np.asarray(ff.wdS),
            }
            for k, a in upd.items():
                self._f[k] = self._pack_faces(a, zero_fill=(k == "wdS"))

    def _gather_local(self, eldofs, x):
        xT = x[:self.n][eldofs]
        xp = x[self.n:][eldofs]
        return jnp.concatenate([xT, xp], axis=1)

    def _scatter_local(self, eldofs, y_e):
        flat = eldofs.reshape(-1)
        yT = jax.ops.segment_sum(y_e[:, :self.nd].reshape(-1), flat,
                                 num_segments=self.n)
        yp = jax.ops.segment_sum(y_e[:, self.nd:].reshape(-1), flat,
                                 num_segments=self.n)
        return jnp.concatenate([yT, yp])

    _FACE_KEYS = ("Bf", "Gf", "invJf", "nrm", "wdS", "eldofs_f",
                  "elem_local")

    def _face_vals(self):
        """Current SEB face arrays as a tuple — passed through the jit
        boundary as call-time arguments so update_geometry's refresh
        reaches the compiled kernels (empty when no SEB)."""
        if self.seb is None:
            return ()
        return tuple(self._f[k] for k in self._FACE_KEYS)

    def _face_rT(self, T, p, Xo, bc, fargs):
        """Local face-flux residual contributions (nf_local, nd) plus the
        owning local element ids — runs inside shard_map."""
        branch, model, bprime = self.seb
        Bf, Gf, invJf, nrm, wdS, eldofs_f, elem_local = fargs
        face_res = self.sys.seb_face_res_fn(branch, model, bprime)
        Xrep = Xo[elem_local, 0]
        rT = jax.vmap(face_res,
                      in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None))(
            T[eldofs_f], p[eldofs_f], Bf, Gf, invJf, nrm, wdS, Xrep, bc)
        return rT, eldofs_f, elem_local

    # -- residual -------------------------------------------------------------

    def _ale_slabs(self, wq, gcl, nel, nq, dim, dtype):
        """Local ALE mesh-velocity / GCL-Jacobian slabs (zeros / disabled
        sentinels when not provided)."""
        if wq is None:
            wq = jnp.zeros((nel, nq, dim), dtype)
        if gcl is None:
            Jo = Jn = jnp.full((nel, nq), -1.0, dtype)
        else:
            Jo, Jn = gcl
        return wq, Jo, Jn

    def _residual_impl(self, invJ_a, wdetJ_a, fvals, T, p, T_old_q,
                       p_old_q, X_old, dt, bc, wq, gcl):
        axis = self.axis
        elem_res = self.sys.elem_residual_fn(
            dt, gcl_enabled=gcl is not None, ale_toggles=self.ale_toggles)
        nq = wdetJ_a.shape[1]
        dim = invJ_a.shape[-1]
        with_seb = self.seb is not None

        @partial(jax.shard_map, mesh=self.mesh,
                 in_specs=(P(axis), P(axis), P(axis), P(), P(),
                           P(axis), P(axis), P(axis), P(), P(axis),
                           P(axis))
                 + tuple(P(axis) for _ in fvals),
                 out_specs=P())
        def _res(eldofs, invJ, wdetJ, T, p, To, po, Xo, bc, wq, gcl,
                 *fargs):
            T_e = T[eldofs]
            p_e = p[eldofs]
            wqe, Jo, Jn = self._ale_slabs(wq, gcl, eldofs.shape[0], nq,
                                          dim, T.dtype)
            rT_e, rp_e = jax.vmap(elem_res)(
                T_e, p_e, invJ, wdetJ, To, po, Xo, wqe, Jo, Jn)
            y = self._scatter_local(eldofs, jnp.concatenate([rT_e, rp_e],
                                                            axis=1))
            if with_seb:
                rTf, eldofs_f, _ = self._face_rT(T, p, Xo, bc, fargs)
                yT_f = jax.ops.segment_sum(rTf.reshape(-1),
                                           eldofs_f.reshape(-1),
                                           num_segments=self.n)
                y = y + jnp.concatenate([yT_f, jnp.zeros_like(yT_f)])
            return jax.lax.psum(y, axis)

        R = _res(self.eldofs, invJ_a, wdetJ_a, jnp.asarray(T),
                 jnp.asarray(p), T_old_q, p_old_q, X_old, bc, wq, gcl,
                 *fvals)
        return jnp.where(self.mask2, 0.0, R)

    def residual(self, T, p, T_old_q, p_old_q, X_old, dt, bc=None,
                 wq=None, gcl=None):
        """BC-masked global residual (2n,) — replicated output.  The
        per-element state arrays must be padded/sharded via ``pad_elem``;
        ``bc`` is the aerothermal BoundaryState (SEB instances only);
        ``wq`` ((ne, nq, dim) mesh velocity at QPs) and ``gcl``
        ((J_old, J_new) per-QP Jacobian pairs) enable the case-2.2 ALE
        advective and geometric-conservation terms — pad/shard them with
        ``pad_elem`` too."""
        return self._residual_j(self.invJ, self.wdetJ, self._face_vals(),
                                T, p, T_old_q, p_old_q, X_old,
                                jnp.asarray(dt), bc, wq, gcl)

    # -- Jacobian preparation --------------------------------------------------

    def _prepare_impl(self, invJ_a, wdetJ_a, fvals, T, p, T_old_q,
                      p_old_q, X_old, dt, bc, wq, gcl):
        axis = self.axis
        elem_res = self.sys.elem_residual_fn(
            dt, gcl_enabled=gcl is not None, ale_toggles=self.ale_toggles)
        nq = wdetJ_a.shape[1]
        dim = invJ_a.shape[-1]
        nd = self.nd
        n = self.n
        mask2 = self.mask2
        with_seb = self.seb is not None

        @partial(jax.shard_map, mesh=self.mesh,
                 in_specs=(P(axis), P(axis), P(axis), P(), P(),
                           P(axis), P(axis), P(axis), P(axis), P(),
                           P(axis), P(axis))
                 + tuple(P(axis) for _ in fvals),
                 out_specs=(P(axis), P(), P()))
        def _prep(eldofs, invJ, wdetJ, T, p, To, po, Xo, lmask, bc, wq,
                  gcl, *fargs):
            T_e = T[eldofs]
            p_e = p[eldofs]
            wqe, Jo, Jn = self._ale_slabs(wq, gcl, eldofs.shape[0], nq,
                                          dim, T.dtype)
            jac = jax.vmap(jax.jacfwd(elem_res, argnums=(0, 1)))
            (JTT, JTp), (JpT, Jpp) = jac(T_e, p_e, invJ, wdetJ, To, po, Xo,
                                         wqe, Jo, Jn)
            top = jnp.concatenate([JTT, JTp], axis=2)
            bot = jnp.concatenate([JpT, Jpp], axis=2)
            Je = jnp.concatenate([top, bot], axis=1)     # (nel, 2nd, 2nd)
            if with_seb:
                # AD face blocks folded into the owning local elements
                branch, model, bprime = self.seb
                Bf, Gf, invJf, nrm, wdS, eldofs_f, elem_local = fargs
                face_res = self.sys.seb_face_res_fn(branch, model, bprime)
                Xrep = Xo[elem_local, 0]
                jacf = jax.vmap(jax.jacfwd(face_res, argnums=(0, 1)),
                                in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None))
                FJT, FJp = jacf(T[eldofs_f], p[eldofs_f], Bf, Gf, invJf,
                                nrm, wdS, Xrep, bc)
                Fe = jnp.concatenate([FJT, FJp], axis=2)
                Je = Je.at[elem_local, :nd, :].add(Fe)
            # shared BC-elimination/equilibration/PC kernel with the
            # shared-DOF reductions expressed as one psum each
            return equilibrated_block_factors(
                Je, lmask, mask2,
                lambda x: self._gather_local(eldofs, x),
                lambda y_e: self._scatter_local(eldofs, y_e),
                nd, n, reduce_fn=lambda v: jax.lax.psum(v, axis))

        return _prep(self.eldofs, invJ_a, wdetJ_a, jnp.asarray(T),
                     jnp.asarray(p), T_old_q, p_old_q, X_old, self.lmask,
                     bc, wq, gcl, *fvals)

    def prepare(self, T, p, T_old_q, p_old_q, X_old, dt, bc=None,
                wq=None, gcl=None):
        """AD-assemble, BC-eliminate, and equilibrate the element Jacobian
        blocks on-device; returns (Je_s sharded, pb, s)."""
        return self._prepare_j(self.invJ, self.wdetJ, self._face_vals(),
                               T, p, T_old_q, p_old_q, X_old,
                               jnp.asarray(dt), bc, wq, gcl)

    # -- linear solve -----------------------------------------------------------

    def _solve_impl(self, Je_s, pb, s, b, rtol, atol):
        axis = self.axis

        @partial(jax.shard_map, mesh=self.mesh,
                 in_specs=(P(axis), P(axis), P()), out_specs=P())
        def _matvec(eldofs, Je_s, y):
            z = self._scatter_local(
                eldofs, jnp.einsum("eij,ej->ei", Je_s,
                                   self._gather_local(eldofs, y)))
            return jax.lax.psum(z, axis)

        return solve_equilibrated(
            lambda y: _matvec(self.eldofs, Je_s, y), pb, s, b,
            self.mask2, self.n, rtol, atol, self.restart, self.maxiter)

    def solve(self, factors, b, rtol=1e-10, atol=0.0):
        """Distributed GMRES solve of J dx = b (factors from ``prepare``)."""
        Je_s, pb, s = factors
        return self._solve(Je_s, pb, s, jnp.asarray(b),
                           jnp.asarray(rtol, dtype=jnp.result_type(b)),
                           jnp.asarray(atol, dtype=jnp.result_type(b)))

    # -- one full Newton iterate ------------------------------------------------

    def newton_step(self, T, p, T_old_q, p_old_q, X_old, dt, rtol=1e-10,
                    bc=None, wq=None, gcl=None):
        """One distributed Newton iterate: residual -> AD Jacobian ->
        equilibrated block GMRES -> update.  Returns (T', p', |R|, cycles).
        Essential DOFs are held fixed (the caller pre-sets BC values)."""
        R = self.residual(T, p, T_old_q, p_old_q, X_old, dt, bc=bc, wq=wq,
                          gcl=gcl)
        fac = self.prepare(T, p, T_old_q, p_old_q, X_old, dt, bc=bc, wq=wq,
                           gcl=gcl)
        res = self.solve(fac, -R, rtol=rtol)
        dx = res.x
        n = self.n
        return (T + dx[:n], p + dx[n:], jnp.linalg.norm(R), res.iters)
