"""Jittable Krylov solvers: preconditioned CG and restarted GMRES.

Replacement for the PETSc KSP solves the reference performs
(GMRES+Jacobi in Input/petsc.opts, GMRES+BJacobi/ILU in petsc_nonlinear.opts,
CG in mesh_recession_handler.cpp:270-276).  Everything is
``lax.while_loop``-based with static shapes, so the solves stay on device
and fuse under jit.  Reductions are plain ``jnp`` sums, which lower to XLA
collectives when the operands are sharded over a device mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class SolveResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray
    residual: jnp.ndarray  # final residual norm (CG: preconditioned rz norm^1/2 proxy)
    converged: jnp.ndarray
    # total inner Krylov iterations (GMRES: Arnoldi steps summed over
    # restart cycles; CG: == iters).  Defaulted so 4-field constructions
    # elsewhere stay valid; -1 marks "not tracked".
    inner_iters: jnp.ndarray | int = -1
    # GMRES stopped above tol because a full restart cycle improved the
    # true residual by <10% — the working-precision floor (f32 chips
    # asked for the deck's f64 rtol) or a defeated preconditioner.
    # Callers should treat converged|stagnated as a usable iterate and
    # let the outer (Newton) convergence check arbitrate; NOT stagnated
    # and NOT converged means the cycle cap hit while still progressing
    # (raise gmres_maxiter).
    stagnated: jnp.ndarray | bool = False
    # final residual norm relative to |M b| (GMRES only; -1.0 marks "not
    # tracked").  The inexact-Newton arbitration quantity: a direction
    # with rel_residual << 1 reduces the linearized residual by that
    # factor, which is all an outer Newton iteration needs
    # (Eisenstat-Walker forcing eta < 1), even when the clamped
    # tolerance was missed within the cycle cap.
    rel_residual: jnp.ndarray | float = -1.0


def _identity(x):
    return x


def neumaier_dot(a, b, chunks: int = 256):
    """Compensated (Neumaier/Kahan) dot product for f32 accuracy studies.

    Products are formed in the working dtype, chunk partial sums use the
    fast tree reduction, and the ``chunks`` partials are combined with a
    sequential Neumaier compensation (a lax.scan of length ``chunks``) —
    the accumulation error drops from O(eps*sqrt(chunks)) to O(eps)
    while the elementwise product rounding (unfixable without wider
    hardware arithmetic) remains.  Pass as ``cg(..., dot=neumaier_dot)``;
    PARITY.md records the measured effect on-chip."""
    a = jnp.ravel(a)
    b = jnp.ravel(b)
    n = a.shape[0]
    c = min(chunks, n)
    pad = (-n) % c
    p = (a * b)
    p = jnp.pad(p, (0, pad)).reshape(c, -1)
    partials = jnp.sum(p, axis=1)

    def step(carry, v):
        s, comp = carry
        t = s + v
        comp = comp + jnp.where(jnp.abs(s) >= jnp.abs(v),
                                (s - t) + v, (v - t) + s)
        return (t, comp), None

    (s, comp), _ = jax.lax.scan(step, (jnp.zeros((), p.dtype),
                                       jnp.zeros((), p.dtype)), partials)
    return s + comp


def cg(apply_A: Callable, b, x0=None, M: Callable | None = None,
       rtol=1e-12, atol=0.0, maxiter=1000,
       dot: Callable | None = None, stall_window: int = 64) -> SolveResult:
    """Preconditioned conjugate gradients for SPD operators.

    ``dot`` overrides the inner product (default ``jnp.vdot``) — e.g.
    ``neumaier_dot`` for the compensated-accumulation experiment.

    ``stall_window``: stop (and flag ``stagnated``) when the residual
    norm fails to improve 10% below its best over that many consecutive
    iterations — the working-precision floor of the arithmetic, which
    the deck f64 rtols (1e-10..1e-12) sit below on f32 chips.  CG's
    residual is non-monotone, so the window is long.  0 disables the
    stall exits AND the residual-replacement checkpoints (plain CG
    recurrence, no extra operator applies); the recursive-residual
    tolerance exit and the explicit final true-residual check remain,
    so a solve whose recursion passed tol while the truth did not is
    still reported ``stagnated``.

    Stagnation, the convergence test, and the reported
    ``residual``/``rel_residual`` are all anchored on EXPLICITLY
    computed true residuals ``b - A x`` (ADVICE r3 #1): the recursive
    residual keeps shrinking below the true-residual floor in f32 (it
    measures the consistency of its own recurrence, not the error).
    Every ``stall_window/2`` iterations the recursive residual is
    REPLACED by the true one (standard residual replacement; one extra
    operator apply per half-window), and two stall signals are tracked:

      (1) DETACHMENT — at a replacement checkpoint the true residual is
          >4x the recursive one.  The recursion has decoupled from the
          error, which is exactly the working-precision-floor
          signature; two consecutive detached checkpoints exit.  A
          healthy solve in any precision keeps the two residuals glued
          (they diverge only at the floor), so slow or oscillating
          convergence never trips this.
      (2) FLAT WINDOW — no 10%-below-best improvement for
          ``stall_window`` iterations AND the current residual sits
          within 2x of the historical best.  The nearness guard
          distinguishes a converged-flat floor (e.g. an inconsistent
          system in f64, where recursion and truth agree) from CG's
          legitimate residual EXCURSIONS on ill-conditioned SPD systems,
          whose 2-norm can rise far above the eventual path back down
          (the Jacobi-preconditioned elasticity bench rises to 29x |b|
          for ~300 iterations before converging to 1e-10).

    The final residual is recomputed explicitly after the loop."""
    b = jnp.asarray(b)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0).astype(b.dtype)
    M = M or _identity
    dot = dot or jnp.vdot
    window = int(stall_window) if stall_window else (maxiter + 1)
    # trued-residual checkpoint period: two per stall window; with
    # stall_window=0 the checkpoints are disabled too (never fire), so
    # no hidden operator applies run when stall detection is off
    check = max(1, window // 2) if stall_window else (maxiter + 2)

    r0 = (b - apply_A(x0)).astype(b.dtype)
    z0 = M(r0)
    rz0 = dot(r0, z0)
    bnorm = jnp.linalg.norm(b)
    tol2 = jnp.maximum(rtol * bnorm, atol) ** 2

    def _flat(st):
        # no new minimum for a full window AND the latest TRUE residual
        # sits near the best TRUE value: a converged-flat floor, not an
        # excursion.  True (checkpoint) values only — the recursive
        # residual dips below the floor and would poison the guard.
        (x, r, z, p, rz, rr, k, rr_best, kbest, detach, rr_true,
         rr_true_best) = st
        return (k - kbest >= window) & (rr_true <= 4.0 * rr_true_best)

    def cond(state):
        rr, k, detach = state[5], state[6], state[9]
        return (k < maxiter) & (rr > tol2) & (detach < 2) & ~_flat(state)

    def body(state):
        (x, r, z, p, rz, rr, k, rr_best, kbest, detach, rr_true,
         rr_true_best) = state
        Ap = apply_A(p).astype(b.dtype)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rr_rec = dot(r, r)
        # residual replacement at checkpoints: swap the recursive
        # residual for the explicit b - A x before the preconditioner
        # and direction update, so the recurrence re-anchors on truth
        do_check = (k + 1) % check == 0
        r = jax.lax.cond(do_check,
                         lambda xx, rr_: (b - apply_A(xx)).astype(b.dtype),
                         lambda xx, rr_: rr_, x, r)
        z = M(r).astype(b.dtype)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rr = dot(r, r)           # true rr at checkpoints, recursive else
        detached = do_check & (rr > 16.0 * rr_rec)  # 4x in norm
        detach = jnp.where(do_check,
                           jnp.where(detached, detach + 1, 0), detach)
        rr_true = jnp.where(do_check, rr, rr_true)
        rr_true_best = jnp.where(do_check,
                                 jnp.minimum(rr, rr_true_best),
                                 rr_true_best)
        improved = rr < 0.81 * rr_best  # 10% in norm = 19% in norm^2
        rr_best = jnp.minimum(rr, rr_best)
        kbest = jnp.where(improved, k + 1, kbest)
        return (x, r, z, p, rz_new, rr, k + 1, rr_best, kbest, detach,
                rr_true, rr_true_best)

    z0 = z0.astype(b.dtype)
    rr0 = dot(r0, r0)
    state = (x0, r0, z0, z0, rz0.astype(b.dtype), rr0,
             jnp.asarray(0), rr0, jnp.asarray(0), jnp.asarray(0),
             rr0, rr0)
    state = jax.lax.while_loop(cond, body, state)
    k, detach = state[6], state[9]
    rr, kbest = state[5], state[8]
    x = state[0]
    # explicit final residual: the recursive r under-reports in f32
    rnorm = jnp.linalg.norm(b - apply_A(x))
    converged = rnorm <= jnp.sqrt(tol2) + 1e-300
    # stagnated: the true residual is above tol but the loop exited on a
    # floor signal — detachment, the guarded flat window, or the
    # RECURSIVE residual passing a tolerance the true one cannot reach.
    # A plain maxiter exit stays unflagged.
    stagnated = (~converged) & ((detach >= 2) | _flat(state)
                                | (rr <= tol2))
    return SolveResult(x, k, rnorm, converged, stagnated=stagnated,
                       rel_residual=rnorm / jnp.maximum(bnorm, 1e-300))


def gmres(apply_A: Callable, b, x0=None, M: Callable | None = None,
          rtol=1e-12, atol=0.0, restart=50, maxiter=20) -> SolveResult:
    """Restarted GMRES(m) with left preconditioning.

    maxiter counts outer restarts; total Krylov iterations <= restart*maxiter.
    Static shapes: the Krylov basis is a fixed (restart+1, n) array, but the
    Arnoldi loop is a ``while_loop`` with Givens-rotation residual tracking,
    so a cycle stops at convergence/breakdown instead of always running m
    matvecs.  The progressive Givens QR (instead of a terminal lstsq on the
    full m columns) is what makes the solver f32-safe: post-breakdown noise
    columns never enter the triangular solve, which a batched lstsq in f32
    turns into garbage directions (the raw (T,p) ablation system solved in
    f32 diverged through exactly that path)."""
    b = jnp.asarray(b)
    n = b.shape[0]
    dtype = b.dtype
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    M = M or _identity

    bnorm = jnp.linalg.norm(M(b))
    # Working-precision floor: an rtol below ~16 eps (the deck's f64
    # linear_rtol=1e-10 asked of an f32 chip) is unreachable, and the
    # Givens residual ESTIMATE keeps shrinking below the true floor, so
    # without the clamp every cycle runs all m Arnoldi steps and every
    # solve costs the full restart*maxiter iterations (measured 5.1 s
    # per ablation Newton iteration on-chip vs ~0.1 s clamped).
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    tol = jnp.maximum(jnp.maximum(rtol * bnorm, atol), 16.0 * eps * bnorm)
    m = restart

    def arnoldi_body(state):
        V, R, g, cs, sn, j, res = state
        v = V[j]
        w = M(apply_A(v))
        # modified Gram-Schmidt (vectorized over previous basis; masked)
        mask = (jnp.arange(m + 1) <= j).astype(dtype)
        h = (V @ w) * mask
        w = w - V.T @ h
        # reorthogonalize once for robustness
        h2 = (V @ w) * mask
        w = w - V.T @ h2
        h = h + h2
        hj1 = jnp.linalg.norm(w)
        V = V.at[j + 1].set(jnp.where(hj1 > tiny, w / hj1,
                                      jnp.zeros_like(w)))
        # apply the previous rotations to the new column
        def rot(i, hv):
            hi = cs[i] * hv[i] + sn[i] * hv[i + 1]
            hi1 = -sn[i] * hv[i] + cs[i] * hv[i + 1]
            return hv.at[i].set(hi).at[i + 1].set(hi1)

        h = h.at[j + 1].set(hj1)
        h = jax.lax.fori_loop(0, j, rot, h)
        # new rotation annihilating h[j+1]
        denom = jnp.sqrt(h[j] ** 2 + h[j + 1] ** 2)
        c = jnp.where(denom > tiny, h[j] / jnp.maximum(denom, tiny), 1.0)
        s = jnp.where(denom > tiny, h[j + 1] / jnp.maximum(denom, tiny), 0.0)
        h = h.at[j].set(denom).at[j + 1].set(0.0)
        cs = cs.at[j].set(c)
        sn = sn.at[j].set(s)
        R = R.at[:, j].set(h)
        g = g.at[j + 1].set(-s * g[j]).at[j].set(c * g[j])
        return (V, R, g, cs, sn, j + 1, jnp.abs(g[j + 1]))

    def arnoldi_cond(state):
        _, _, _, _, _, j, res = state
        return jnp.logical_and(j < m, res > tol)

    def restart_cycle(x, r):
        # r is the CURRENT preconditioned residual (threaded through the
        # outer loop so each restart costs exactly one extra apply for
        # its explicit end-of-cycle residual, not two)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), dtype=dtype)
        V = V.at[0].set(jnp.where(beta > tiny, r / beta, r))
        R = jnp.zeros((m + 1, m), dtype=dtype)
        g = jnp.zeros(m + 1, dtype=dtype).at[0].set(beta)
        cs = jnp.zeros(m, dtype=dtype)
        sn = jnp.zeros(m, dtype=dtype)
        V, R, g, cs, sn, k, _ = jax.lax.while_loop(
            arnoldi_cond, arnoldi_body, (V, R, g, cs, sn, jnp.asarray(0),
                                         beta))
        # triangular solve over the k active columns.  Inactive columns
        # are zero, and an ACTIVE column can also carry a ~zero pivot
        # (exact breakdown: h = hj1 = 0, e.g. a singular operator whose
        # nullspace the Krylov space hit) — both get a unit diagonal and
        # zero rhs so y vanishes there instead of dividing by ~0.
        active = jnp.arange(m) < k
        usable = active & (jnp.abs(jnp.diagonal(R[:m, :m])) > tiny)
        Rsolve = R[:m, :m] + jnp.diag(jnp.where(usable, 0.0, 1.0)
                                      .astype(dtype))
        gg = jnp.where(usable, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Rsolve, gg, lower=False)
        x_new = x + V[:m].T @ y
        # explicit (not Givens-estimated) residual: the estimate drifts
        # in f32; this is also the next cycle's starting vector
        r_new = M(b - apply_A(x_new))
        return x_new, r_new, jnp.linalg.norm(r_new), k

    def cond(state):
        x, r, res, prev, k, ki = state
        # stop on convergence, the cycle cap, or stagnation: a full
        # restart cycle that improved the TRUE residual by <10% means
        # the iteration sits on the working-precision floor (or the
        # operator defeats the preconditioner) — further cycles only
        # burn restart-length Arnoldi sweeps.  NaN residuals also exit
        # here (NaN comparisons are False).
        return (k < maxiter) & (res > tol) & (res < 0.9 * prev)

    def body(state):
        x, r, res, prev, k, ki = state
        x, r, res_new, k_in = restart_cycle(x, r)
        return (x, r, res_new, res, k + 1, ki + k_in)

    r0 = M(b - apply_A(x0)).astype(dtype)
    x, r, res, prev, k, ki = jax.lax.while_loop(
        cond, body, (x0.astype(dtype), r0, jnp.linalg.norm(r0),
                     jnp.asarray(jnp.inf, dtype),
                     jnp.asarray(0), jnp.asarray(0)))
    stagnated = (res > tol) & ~(res < 0.9 * prev)
    relres = res / jnp.maximum(bnorm, jnp.asarray(
        jnp.finfo(dtype).tiny, dtype))
    return SolveResult(x, k, res, res <= tol, ki, stagnated, relres)
