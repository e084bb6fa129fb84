"""Preconditioners: Jacobi and Chebyshev polynomial.

These replace the PETSc PC configurations the reference selects via option
files (`-pc_type jacobi` in Input/petsc.opts, block-Jacobi/ILU in
petsc_nonlinear.opts).  Chebyshev gives a stronger, matmul-only polynomial
preconditioner that maps well onto accelerators (no triangular solves)."""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def jacobi_preconditioner(diag) -> Callable:
    """M^{-1} = diag(A)^{-1}; tolerant of constrained identity rows."""
    d = jnp.asarray(diag)
    inv = jnp.where(jnp.abs(d) > 1e-300, 1.0 / d, 1.0)

    def M(r):
        return inv * r

    return M


def power_iteration_lmax(apply_A: Callable, n: int, iters: int = 30,
                         key=None, dtype=jnp.float64):
    """Estimate the largest eigenvalue of A (SPD) by power iteration."""
    if key is None:
        key = jax.random.PRNGKey(0)
    v0 = jax.random.normal(key, (n,), dtype=dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    def body(i, carry):
        v, lam = carry
        w = apply_A(v)
        lam = jnp.vdot(v, w)
        nw = jnp.linalg.norm(w)
        return (jnp.where(nw > 0, w / nw, v), lam)

    v, lam = jax.lax.fori_loop(0, iters, body, (v0, jnp.asarray(1.0, dtype)))
    return lam


def chebyshev_smooth(Aop: Callable, rs, lmax, degree: int, lmin=None):
    """z ~= A^{-1} rs via the Chebyshev iteration with z0 = 0 on
    [lmin, lmax] (lmin defaults to the lmax/30 smoothing heuristic).

    The single implementation of the theta/delta/sigma/rho recurrence —
    the Jacobi-CG preconditioner and both multigrid smoothers
    (GeometricMG/StructuredMG) all call this, so eigenvalue-margin or
    recurrence fixes land once."""
    lmax = jnp.asarray(lmax)
    lmin = lmax / 30.0 if lmin is None else jnp.asarray(lmin)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    z = rs / theta
    d = z
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        # d_{k+1} = rho_{k+1} rho_k d_k + (2 rho_{k+1}/delta)(rs - A z_k)
        d = rho_new * (2.0 / delta * (rs - Aop(z)) + rho * d)
        z = z + d
        rho = rho_new
    return z


def chebyshev_preconditioner(apply_A: Callable, lmax, lmin=None,
                             degree: int = 4, diag=None) -> Callable:
    """Chebyshev polynomial approximation of A^{-1} on [lmin, lmax].

    With `diag` given, preconditions the Jacobi-scaled operator
    D^{-1/2} A D^{-1/2} (the standard matrix-free smoother construction).
    """
    if diag is not None:
        dinv = 1.0 / jnp.asarray(diag)

        def Aop(x):
            return dinv * apply_A(x)
    else:
        dinv = None
        Aop = apply_A

    def M(r):
        if dinv is not None:
            r = dinv * r
        return chebyshev_smooth(Aop, r, lmax, degree, lmin)

    return M
