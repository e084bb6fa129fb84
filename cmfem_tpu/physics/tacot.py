"""TACOT charring-ablator material model (PATO-style), vectorized in JAX.

Clean-room re-implementation of the reference's ``TACOTMaterial``
(/root/reference/myapps/convection_diffusion/tacot_material.{hpp,cpp}):

- per-QP Arrhenius reaction extents advanced by an implicit scalar Newton
  (SolveReactionExtents, tacot_material.cpp:208-280) — here a
  fixed-iteration vectorized Newton over ALL quadrature points at once,
  wrapped in a ``custom_jvp`` that differentiates the converged solution by
  the implicit-function theorem (with clamp-zeroing, matching the
  reference's frozen-derivative semantics at the x in [x_old, 1] clamps);
- virgin/char property blending by the virgin-mass fraction tau
  (EvaluateSolid, :282-402);
- ideal-gas properties from tables (EvaluateGas, :404-419);
- natural cubic splines in T per pressure level, linear in p with clamping
  (CubicSpline1D :571-673, MultiTable2D :693-865).  All table data is
  baked to dense (L, nprop, nT) arrays at load (T grids are uniform
  across levels in every shipped material deck).

Everything is jnp and batched over arbitrary leading shapes, so the whole
material evaluation fuses into the ablation residual under jit.
"""

from __future__ import annotations

from dataclasses import dataclass

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.yamlcfg import yaml_safe_load


def natural_spline_y2(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Second derivatives of the natural cubic spline through (x, y).

    y may have leading batch dims (..., n). Thomas-algorithm sweep with
    natural (zero second derivative) end conditions."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[-1]
    y2 = np.zeros_like(y)
    if n < 3:
        return y2
    u = np.zeros(y.shape[:-1] + (n - 1,))
    for i in range(1, n - 1):
        sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
        p = sig * y2[..., i - 1] + 2.0
        y2[..., i] = (sig - 1.0) / p
        dy1 = (y[..., i + 1] - y[..., i]) / (x[i + 1] - x[i])
        dy0 = (y[..., i] - y[..., i - 1]) / (x[i] - x[i - 1])
        u[..., i] = (6.0 * (dy1 - dy0) / (x[i + 1] - x[i - 1])
                     - sig * u[..., i - 1]) / p
    y2[..., n - 1] = 0.0
    for k in range(n - 2, -1, -1):
        y2[..., k] = y2[..., k] * y2[..., k + 1] + u[..., k]
    return y2


def spline_eval(x, y, y2, xq):
    """Evaluate natural cubic splines with end-clamping.

    x (nT,), y/y2 (..., nT) broadcast against query xq (...,).
    Returns (value, deriv, clamped); outside [x0, xN] the end value is
    returned with deriv = 0 (reference EvalClampWithDerivative).

    The interval lookup is vectorized comparisons + a one-hot
    contraction against the (nT-1, 4) stacked knot table instead of
    searchsorted + four gathers.  Results are bit-identical: the interval
    index reproduces searchsorted-left semantics exactly.
    """
    x = jnp.asarray(x)
    n = x.shape[0]
    xq = jnp.asarray(xq)
    # searchsorted(x, xq, 'left') == #{i: x[i] < xq}; vectorized compare
    ss = jnp.sum(xq[..., None] > x, axis=-1)
    khi = jnp.clip(ss, 1, n - 1)
    k = khi - 1                                   # interval index (n-1)
    onehot = (k[..., None] == jnp.arange(n - 1)).astype(xq.dtype)
    # stacked per-interval data: x_lo, x_hi applied from the static knots.
    # HIGHEST is already the package-wide default matmul precision, but
    # pin it here too: a bf16-operand contraction of ~3000 K knots would
    # silently lose ~5 significant digits of the interval geometry
    hi = jax.lax.Precision.HIGHEST
    xlo = jnp.dot(onehot, x[:-1], precision=hi)
    xhi = jnp.dot(onehot, x[1:], precision=hi)
    if y.ndim == 1:
        tab = jnp.stack([y[:-1], y[1:], y2[:-1], y2[1:]], axis=-1)
        g = jnp.dot(onehot, tab, precision=hi)    # (..., 4)
        ylo, yhi, y2lo, y2hi = (g[..., 0], g[..., 1], g[..., 2], g[..., 3])
        y_first, y_last = y[0], y[-1]
    else:
        # batched coefficient sets aligned with xq: per-batch interval
        # selection (jnp.take along the last axis would outer-product the
        # batch dims; the ablation hot path uses 1-D per-level coefficients
        # and never reaches this branch)
        ylo = jnp.take_along_axis(y, k[..., None], axis=-1)[..., 0]
        yhi = jnp.take_along_axis(y, khi[..., None], axis=-1)[..., 0]
        y2lo = jnp.take_along_axis(y2, k[..., None], axis=-1)[..., 0]
        y2hi = jnp.take_along_axis(y2, khi[..., None], axis=-1)[..., 0]
        y_first = jnp.take(y, 0, axis=-1)
        y_last = jnp.take(y, n - 1, axis=-1)
    h = xhi - xlo
    a = (xhi - xq) / h
    b = (xq - xlo) / h
    val = (a * ylo + b * yhi
           + ((a**3 - a) * y2lo + (b**3 - b) * y2hi) * (h * h) / 6.0)
    der = ((yhi - ylo) / h
           + (h / 6.0) * (-(3 * a * a - 1) * y2lo + (3 * b * b - 1) * y2hi))
    lo_clamp = xq <= x[0]
    hi_clamp = xq >= x[-1]
    val = jnp.where(lo_clamp, y_first, val)
    val = jnp.where(hi_clamp, y_last, val)
    der = jnp.where(lo_clamp | hi_clamp, 0.0, der)
    return val, der, lo_clamp | hi_clamp


def spline_eval_multi(x, ys, y2s, xq):
    """Evaluate L natural cubic splines SHARING one knot grid at the
    same queries: x (nT,), ys/y2s (L, nT), xq (...,) ->
    (val (L, ...), der (L, ...), clamped (L, ...)).

    Semantics identical to ``jax.vmap(lambda y, y2: spline_eval(x, y,
    y2, xq))(ys, y2s)`` — but that vmap lowers the per-level
    ``dot(onehot, tab_l)`` to a batched matmul whose lhs is the one-hot
    BROADCAST across L: at refine-3 ablation scale (1.5M QPs, 151
    knots) that is a 22 GB intermediate that cannot compile on-chip.
    Here the one-hot is contracted against ALL levels' knot tables in
    ONE (nqp, nT-1) @ (nT-1, 4L) matmul; above
    CMFEM_SPLINE_ONEHOT_MAX one-hot entries the leading query axis is
    additionally CHUNKED through a sequential ``lax.map`` so peak
    memory stays bounded regardless of problem size."""
    x = jnp.asarray(x)
    n = x.shape[0]
    xq_in = jnp.asarray(xq)
    ys = jnp.asarray(ys)
    y2s = jnp.asarray(y2s)
    L = ys.shape[0]
    nqp = int(np.prod(xq_in.shape)) if xq_in.shape else 1
    budget = int(os.environ.get("CMFEM_SPLINE_ONEHOT_MAX",
                                str(16 * 1024 * 1024)))
    if nqp * (n - 1) > budget:
        # flatten the queries (multi-dim query shapes pad the one-hot's
        # sublane axis — measured 3.0x expansion for (..., 9, 151) f32
        # tiles) and evaluate in sequential lax.map chunks so peak
        # memory is bounded at any problem size
        flat = xq_in.reshape(-1)
        chunk = max(1, budget // (n - 1))
        nch = -(-nqp // chunk)
        pad = nch * chunk - nqp
        flat_p = jnp.concatenate(
            [flat, jnp.broadcast_to(flat[:1], (pad,))]) if pad else flat
        v, d, c = jax.lax.map(
            lambda xc: spline_eval_multi(x, ys, y2s, xc),
            flat_p.reshape(nch, chunk))
        out = []
        for a in (v, d, c):
            a = jnp.moveaxis(a, 0, 1).reshape(L, nch * chunk)[:, :nqp]
            out.append(a.reshape((L,) + xq_in.shape))
        return tuple(out)
    xq = xq_in
    ss = jnp.sum(xq[..., None] > x, axis=-1)
    k = jnp.clip(ss, 1, n - 1) - 1
    onehot = (k[..., None] == jnp.arange(n - 1)).astype(xq.dtype)
    hi = jax.lax.Precision.HIGHEST
    xlo = jnp.dot(onehot, x[:-1], precision=hi)
    xhi = jnp.dot(onehot, x[1:], precision=hi)
    # (L, nT-1, 4) -> (nT-1, 4L): one contraction for every level
    tab = jnp.stack([ys[:, :-1], ys[:, 1:], y2s[:, :-1], y2s[:, 1:]],
                    axis=-1)
    tab2 = jnp.moveaxis(tab, 0, 1).reshape(n - 1, 4 * L)
    g = jnp.dot(onehot, tab2, precision=hi)       # (..., 4L)
    g = jnp.moveaxis(g.reshape(g.shape[:-1] + (L, 4)), -2, 0)
    ylo, yhi, y2lo, y2hi = (g[..., 0], g[..., 1],
                            g[..., 2], g[..., 3])
    h = xhi - xlo
    a = (xhi - xq) / h
    b = (xq - xlo) / h
    val = (a * ylo + b * yhi
           + ((a ** 3 - a) * y2lo + (b ** 3 - b) * y2hi) * (h * h) / 6.0)
    der = ((yhi - ylo) / h
           + (h / 6.0) * (-(3 * a * a - 1) * y2lo
                          + (3 * b * b - 1) * y2hi))
    lo_clamp = xq <= x[0]
    hi_clamp = xq >= x[-1]
    shape1 = (L,) + (1,) * (val.ndim - 1)
    val = jnp.where(lo_clamp, ys[:, 0].reshape(shape1), val)
    val = jnp.where(hi_clamp, ys[:, -1].reshape(shape1), val)
    clamped = lo_clamp | hi_clamp
    der = jnp.where(clamped, 0.0, der)
    return val, der, jnp.broadcast_to(clamped, val.shape)


@dataclass
class PropertyTable:
    """(p, T) property table: splines in T per pressure level, linear in p.

    p_levels (L,), T_tab (L, nTmax) per-level T knots — RAGGED per-level
    rows supported (the reference's MultiTable2D builds one spline per
    level over that level's own rows, tacot_material.cpp:693-865);
    shorter levels are padded with a monotone knot extension carrying
    the end value (y2=0), and evaluation clamps the query to each
    level's TRUE range so padding is never reached.  T_hi (L,) true top
    knot, y (L, nprop, nTmax), y2 same."""

    p_levels: np.ndarray
    T_tab: np.ndarray
    T_hi: np.ndarray
    y: np.ndarray
    y2: np.ndarray
    log_p: bool = False
    uniform: bool = True

    @property
    def T(self):
        """Shared T grid for uniform tables; level 0's knots otherwise."""
        return self.T_tab[0]

    @classmethod
    def from_yaml_node(cls, node: dict, nprop: int) -> "PropertyTable":
        levels = sorted(node["pressure_tables"], key=lambda t: float(t["p"]))
        ps = np.array([float(t["p"]) for t in levels])
        grids = []
        ys = []
        for t in levels:
            rows = sorted(([float(v) for v in r] for r in t["rows"]),
                          key=lambda r: r[0])
            rows = np.asarray(rows)
            if rows.shape[1] < nprop + 1:
                raise ValueError("Malformed table row")
            if rows.shape[0] < 2:
                raise ValueError("Each pressure level needs >= 2 T rows")
            grids.append(rows[:, 0])
            ys.append(rows[:, 1:nprop + 1].T)  # (nprop, nTl)
        nTmax = max(len(g) for g in grids)
        L = len(ps)
        T_tab = np.zeros((L, nTmax))
        T_hi = np.zeros(L)
        y = np.zeros((L, nprop, nTmax))
        y2 = np.zeros((L, nprop, nTmax))
        uniform = True
        for i, (Tg, yi) in enumerate(zip(grids, ys)):
            nTl = len(Tg)
            npad = nTmax - nTl
            uniform &= (nTl == len(grids[0])
                        and bool(np.allclose(Tg, grids[0])))
            T_hi[i] = Tg[-1]
            dpad = Tg[-1] - Tg[-2]
            T_tab[i] = np.concatenate(
                [Tg, Tg[-1] + dpad * np.arange(1, npad + 1)])
            y[i, :, :nTl] = yi
            y[i, :, nTl:] = yi[:, -1:]
            y2[i, :, :nTl] = natural_spline_y2(Tg, yi)
        return cls(ps, T_tab, T_hi, y, y2, uniform=uniform)

    def eval(self, prop_idx: int, p, T, with_derivs: bool = False):
        """Batched evaluation; returns value or (value, dp, dT, clamped_p,
        clamped_T)."""
        return self.eval_props((prop_idx,), p, T, with_derivs)[0]

    def eval_props(self, prop_idxs, p, T, with_derivs: bool = False):
        """Evaluate SEVERAL properties of this table at the same (p, T)
        queries; returns a list aligned with ``prop_idxs``.

        All (level, property) splines are contracted against ONE
        interval one-hot in ONE matmul.  This is a memory-scaling
        requirement, not a convenience: separate per-property ``eval``
        calls build identical one-hots that XLA groups into a batched
        dot whose BROADCAST lhs materializes (n_dots, nqp, nT-1) — at
        refine-3 ablation scale (1.5M QPs, 151 gas knots, 8 dots) a
        22 GB buffer that cannot compile on-chip."""
        idxs = list(prop_idxs)
        P = len(idxs)
        ps = jnp.asarray(self.p_levels)
        L = len(self.p_levels)
        yj = jnp.asarray(self.y[:, idxs])        # (L, P, nT)
        y2j = jnp.asarray(self.y2[:, idxs])

        T = jnp.asarray(T)
        p = jnp.asarray(p)
        nTmax = yj.shape[-1]

        # evaluate the spline at every pressure level (L is tiny: 2..5).
        # UNIFORM tables (every shipped deck) share one grid, so the
        # (L*P) splines ride one one-hot contraction; ragged tables pay
        # a per-level working set (their own grids).
        if self.uniform:
            v, d, c = spline_eval_multi(
                jnp.asarray(self.T_tab[0]),
                yj.reshape(L * P, nTmax),
                y2j.reshape(L * P, nTmax), T)
            shp = (L, P) + v.shape[1:]
            vals, ders, Tcl = (v.reshape(shp), d.reshape(shp),
                               c.reshape(shp))
        else:
            def level_eval(Tl, Thil, yl, y2l):
                lo = Tl[0]
                Tq = jnp.clip(T, lo, Thil)
                v, d, _ = jax.vmap(
                    lambda a, b: spline_eval(Tl, a, b, Tq))(yl, y2l)
                c = (T <= lo) | (T >= Thil)
                return v, jnp.where(c, 0.0, d), \
                    jnp.broadcast_to(c, v.shape)

            vals, ders, Tcl = jax.vmap(level_eval)(
                jnp.asarray(self.T_tab), jnp.asarray(self.T_hi),
                yj, y2j)

        def _per_prop(value, dp, dT, clamped_p, cT):
            outs = []
            for i in range(P):
                if with_derivs:
                    outs.append((value[i], dp[i], dT[i], clamped_p,
                                 cT[i]))
                else:
                    outs.append(value[i])
            return outs

        if L == 1:
            z = jnp.zeros_like(vals[0, 0])
            return _per_prop(vals[0], jnp.broadcast_to(z, vals[0].shape),
                             ders[0],
                             jnp.zeros(z.shape, bool), Tcl[0])

        pc = jnp.clip(p, ps[0], ps[-1])
        clamped_p = (p <= ps[0]) | (p >= ps[-1])
        hi0 = jnp.clip(jnp.sum(pc[..., None] > ps, axis=-1), 1, L - 1)
        ps_hi0 = jnp.sum(ps * (hi0[..., None] == jnp.arange(L)), axis=-1)
        # exact interior match -> forward interval (reference :829-840)
        p_tol = 1e-12 * jnp.maximum(1.0, jnp.abs(pc))
        exact_int = (jnp.abs(ps_hi0 - pc) <= p_tol) & (hi0 < L - 1) \
            & (~clamped_p)
        lo = jnp.where(exact_int, hi0, hi0 - 1)
        hi = jnp.where(exact_int, hi0 + 1, hi0)
        p0 = jnp.sum(ps * (lo[..., None] == jnp.arange(L)), axis=-1)
        p1 = jnp.sum(ps * (hi[..., None] == jnp.arange(L)), axis=-1)
        w = (pc - p0) / (p1 - p0)
        # one-hot level selection (L is tiny; masked sums stay
        # vectorized)
        oh_lo = (lo[..., None] == jnp.arange(L))
        oh_hi = (hi[..., None] == jnp.arange(L))

        def take(arr, oh):
            # (L, P, ...) -> (P, ..., L), contract L against the
            # query-shaped one-hot (broadcast over the leading P)
            am = jnp.moveaxis(arr, 0, -1)
            if arr.dtype == jnp.bool_:
                return jnp.any(am & oh, axis=-1)
            return jnp.sum(am * oh.astype(am.dtype), axis=-1)

        v0 = take(vals, oh_lo)
        v1 = take(vals, oh_hi)
        d0 = take(ders, oh_lo)
        d1 = take(ders, oh_hi)
        value = (1 - w) * v0 + w * v1
        dT = (1 - w) * d0 + w * d1
        if not with_derivs:
            return [value[i] for i in range(P)]
        c0 = take(Tcl, oh_lo)
        c1 = take(Tcl, oh_hi)
        dp = jnp.where(clamped_p, 0.0, (v1 - v0) / (p1 - p0))
        return _per_prop(value, dp, dT, clamped_p, c0 | c1)


def _make_extent_solver(mat: "TacotMaterial"):
    """Build the custom_jvp'ed implicit extent solver with the material's
    reaction constants closed over as static arrays."""
    # numpy constants: re-materialized per trace (jnp constants captured in
    # a closure built inside a trace would leak tracers across jits)
    A = np.asarray(mat.A)
    E = np.asarray(mat.E)
    m_exp = np.asarray(mat.m_exp)
    n_exp = np.asarray(mat.n_exp)
    T_thr = np.asarray(mat.T_thr)
    R = mat.R
    iters = mat.newton_iters

    def _pieces(T, x):
        Tc = jnp.maximum(T, 1.0)[..., None]
        arr = A * jnp.exp(-E / (R * Tc))
        tpow = jnp.where(n_exp == 0.0, 1.0, jnp.maximum(Tc, 1e-14) ** n_exp)
        one_minus = jnp.maximum(1.0 - x, 1e-14)
        xpow = jnp.where(m_exp == 0.0, 1.0, one_minus ** m_exp)
        dxpow = jnp.where(m_exp == 1.0, 1.0, one_minus ** (m_exp - 1.0))
        return Tc, arr, tpow, xpow, dxpow

    @jax.custom_jvp
    def solve(T, dt, extent_old):
        x_old = jnp.clip(extent_old, 0.0, 1.0)
        Tc, arr, tpow, _, _ = _pieces(T, x_old)
        active = (Tc >= T_thr) & (arr > 0.0) & (dt > 0.0)
        # convergence-gated Newton (max `iters`, the reference's cap): the
        # scalar iteration converges in a handful of steps, so the
        # while_loop exits early instead of always paying 30 sweeps; the
        # derivative is the IFT custom_jvp below, so the loop itself is
        # never differentiated.  Tolerance is dtype-scaled (extents live
        # in [0, 1]).
        tol = 100.0 * jnp.finfo(jnp.result_type(x_old)).eps

        def cond(carry):
            _, it, delta = carry
            return (it < iters) & (delta > tol)

        def body(carry):
            x, it, _ = carry
            _, _, _, xpow, dxpow = _pieces(T, x)
            rate = arr * xpow * tpow
            f = x - x_old - dt * rate
            dfdx = 1.0 + dt * arr * m_exp * dxpow * tpow
            dx = f / jnp.maximum(dfdx, 1e-14)
            x_new = jnp.where(active, jnp.clip(x - dx, x_old, 1.0), x_old)
            return x_new, it + 1, jnp.max(jnp.abs(x_new - x))

        # seed delta from x_old so it carries the same sharding/varying
        # type as the body output under shard_map (an unvarying inf
        # literal trips the while_loop carry check on manual axes)
        delta0 = jnp.asarray(jnp.inf, x_old.dtype) + 0.0 * jnp.max(
            jnp.abs(x_old))
        x, _, _ = jax.lax.while_loop(
            cond, body, (x_old, jnp.asarray(0), delta0))
        return jnp.clip(jnp.where(active, x, x_old), x_old, 1.0)

    @solve.defjvp
    def solve_jvp(primals, tangents):
        """IFT derivative of the converged extents: from
        f(x, T) = x - x_old - dt*rate(x, T) = 0,
          dx/dT = dt (dr/dT) / dfdx, dx/dx_old = 1/dfdx, dx/ddt = rate/dfdx;
        zeroed where the solution sits on a clamp (matching the reference's
        FD through the clamped update)."""
        T, dt, extent_old = primals
        dT, ddt, dx_old_t = tangents
        x = solve(T, dt, extent_old)
        x_old = jnp.clip(extent_old, 0.0, 1.0)
        Tc, arr, tpow, xpow, dxpow = _pieces(T, x)
        rate = arr * xpow * tpow
        darr_dT = arr * (E / (R * Tc * Tc))
        dtpow_dT = jnp.where(n_exp == 0.0, 0.0,
                             n_exp * jnp.maximum(Tc, 1e-14) ** (n_exp - 1.0))
        drate_dT = (darr_dT * xpow * tpow + arr * xpow * dtpow_dT) * \
            jnp.where(T > 1.0, 1.0, 0.0)[..., None]
        dfdx = 1.0 + dt * arr * m_exp * dxpow * tpow
        active = (Tc >= T_thr) & (arr > 0.0) & (dt > 0.0)
        interior = active & (x < 1.0 - 1e-12)
        dx_dT = jnp.where(interior, dt * drate_dT / dfdx, 0.0)
        # non-interior splits: inactive passthrough (x == x_old, unit
        # derivative) vs active-but-clamped at x == 1 (pinned, derivative
        # 0 — the reference's frozen-clamp FD semantics)
        dx_dxold = jnp.where(interior, 1.0 / dfdx,
                             jnp.where(active, 0.0, 1.0))
        dx_ddt = jnp.where(interior, rate / dfdx, 0.0)
        tangent = dx_dT * dT[..., None] + dx_dxold * dx_old_t + dx_ddt * ddt
        return x, tangent

    return solve


def _parse_pato_optics(path: str):
    """Parse a PATO surface property file into a 2-property (emissivity,
    reflectivity) PropertyTable.  Columns: p T cp h ki kj kk emissivity
    reflectivity; ``//`` comments; rows grouped by pressure
    (LoadSurfaceOpticsTableFromSource, tacot_material.cpp:124-197)."""
    if not os.path.isfile(path):
        return None
    grouped: dict = {}
    with open(path) as f:
        for line in f:
            line = line.split("//")[0]
            parts = line.split()
            if len(parts) < 9:
                continue
            try:
                vals = [float(v) for v in parts[:9]]
            except ValueError:
                continue
            p, T = vals[0], vals[1]
            grouped.setdefault(p, []).append((T, vals[7], vals[8]))
    if not grouped:
        return None
    node = {"pressure_tables": [
        {"p": p, "rows": sorted(rows)} for p, rows in sorted(grouped.items())
    ]}
    return PropertyTable.from_yaml_node(node, 2)


@dataclass
class TacotMaterial:
    """Loaded TACOT deck; all methods are jnp-vectorized and jittable."""

    R: float
    min_pi_pyro: float
    rho_eps0: np.ndarray      # (nph,)
    K_v: float
    K_c: float
    eps_g_v: float
    eps_g_c: float
    F: np.ndarray             # (nr,)
    A: np.ndarray
    E: np.ndarray
    m_exp: np.ndarray
    n_exp: np.ndarray
    T_thr: np.ndarray
    h_reac: np.ndarray
    phase: np.ndarray         # (nr,) int
    virgin: PropertyTable
    char: PropertyTable
    gas: PropertyTable
    emissivity_fallback: float = 0.85
    reflectivity_fallback: float = 0.15
    newton_iters: int = 30
    # optional PATO surface-optics (p,T) tables: emissivity + reflectivity
    # per virgin/char state (LoadSurfaceOpticsTableFromSource,
    # tacot_material.cpp:124-197); None -> the 0.85/0.15 fallback
    virgin_optics: PropertyTable | None = None
    char_optics: PropertyTable | None = None

    @classmethod
    def load_yaml(cls, path: str) -> "TacotMaterial":
        with open(path) as f:
            root = yaml_safe_load(f)
        for key in ("constants", "phases", "transport", "reactions", "tables"):
            if key not in root:
                raise ValueError(
                    "Material YAML must define constants, phases, transport, "
                    "reactions, and tables.")
        c = root["constants"]
        ph = root["phases"]
        tr = root["transport"]
        rhoI = np.array([float(v) for v in ph["rhoI"]])
        epsI = np.array([float(v) for v in ph["epsI"]])
        if len(rhoI) < 2 or len(epsI) < 2:
            raise ValueError("phases.rhoI and phases.epsI need >= 2 entries")
        nph = min(len(rhoI), len(epsI))
        reacs = root["reactions"]
        if not reacs:
            raise ValueError("Material YAML must contain at least one reaction.")

        def phase_of(r):
            if "phase_index" in r:
                return int(r["phase_index"])
            if "phase" in r:
                return int(r["phase"]) - 1
            return min(1, nph - 1)

        F = np.array([float(r["F"]) for r in reacs])
        if F.sum() <= 0:
            raise ValueError("Sum of reaction F coefficients must be positive.")
        return cls(
            R=float(c["R"]),
            min_pi_pyro=float(c.get("min_pi_pyro", 1.0e-9)),
            rho_eps0=(rhoI[:nph] * epsI[:nph]),
            K_v=float(tr["K_v"]), K_c=float(tr["K_c"]),
            eps_g_v=float(tr["eps_g_v"]), eps_g_c=float(tr["eps_g_c"]),
            F=F,
            A=np.array([float(r["A"]) for r in reacs]),
            E=np.array([float(r["E"]) for r in reacs]),
            m_exp=np.array([float(r["m"]) for r in reacs]),
            n_exp=np.array([float(r["n"]) for r in reacs]),
            T_thr=np.array([float(r["T_threshold"]) for r in reacs]),
            h_reac=np.array([float(r["h"]) for r in reacs]),
            phase=np.array([min(max(phase_of(r), 0), nph - 1) for r in reacs]),
            virgin=PropertyTable.from_yaml_node(root["tables"]["virgin"], 3),
            char=PropertyTable.from_yaml_node(root["tables"]["char"], 3),
            gas=PropertyTable.from_yaml_node(root["tables"]["gas"], 3),
            **cls._load_surface_optics(root),
        )

    @staticmethod
    def _load_surface_optics(root) -> dict:
        """Optional PATO surface-optics: ``source: path:`` names a PATO
        material directory whose ``virgin``/``char`` files carry 9 columns
        (p T cp h ki kj kk emissivity reflectivity).  Both must parse or
        neither is used (tacot_material.cpp:110-118)."""
        src = (root.get("source") or {}).get("path")
        if not src:
            return {}
        try:
            v = _parse_pato_optics(os.path.join(src, "virgin"))
            c = _parse_pato_optics(os.path.join(src, "char"))
        except (OSError, ValueError):
            return {}
        if v is None or c is None:
            return {}
        return {"virgin_optics": v, "char_optics": c}

    # -- derived scalars ---------------------------------------------------

    @property
    def num_reactions(self) -> int:
        return len(self.F)

    @property
    def rho_virgin(self) -> float:
        return float(self.rho_eps0.sum())

    @property
    def rho_char(self) -> float:
        rc = self.rho_eps0.sum() - (self.rho_eps0[self.phase] * self.F).sum()
        return float(max(rc, 1e-14))

    def initial_solid_density(self) -> float:
        """solid_density at zero extent — delegates to the general
        all-phase sum (a 2-phase hardcode would crash 1-phase decks and
        drop phases beyond the second)."""
        return self.rho_virgin

    def char_solid_density(self) -> float:
        """solid_density at full extent — delegates to the per-reaction
        phase-indexed form (a hardcode assuming every reaction consumes
        phase 1 breaks decks using the loader's phase_index support)."""
        return self.rho_char

    # -- reaction extents --------------------------------------------------

    def _extent_rate(self, x, T):
        """Reaction rate dx/dt at extent x, temperature T (batched ..., nr)."""
        Tc = jnp.maximum(T, 1.0)[..., None]
        arr = self.A * jnp.exp(-self.E / (self.R * Tc))
        one_minus = jnp.maximum(1.0 - x, 1e-14)
        tpow = jnp.where(self.n_exp == 0.0, 1.0,
                         jnp.maximum(Tc, 1e-14) ** self.n_exp)
        xpow = jnp.where(self.m_exp == 0.0, 1.0, one_minus ** self.m_exp)
        rate = arr * xpow * tpow
        active = (Tc >= self.T_thr) & (arr > 0.0)
        return jnp.where(active, rate, 0.0)

    def solve_reaction_extents(self, T, dt, extent_old):
        """Advance extents by implicit backward Euler: x = x_old + dt*rate(x).

        T (...,), dt scalar, extent_old (..., nr) -> extent (..., nr).
        Fixed 30-iteration vectorized Newton (the reference caps at 30,
        tacot_material.cpp:249) with the same clamp x in [x_old, 1];
        differentiable via the implicit-function theorem (custom_jvp)."""
        if not hasattr(self, "_extent_solver"):
            object.__setattr__(self, "_extent_solver",
                               _make_extent_solver(self))
        return self._extent_solver(jnp.asarray(T), jnp.asarray(dt),
                                   jnp.asarray(extent_old))

    # -- bulk properties ---------------------------------------------------

    def tau(self, extent):
        """Virgin-mass fraction weighting (ComputeTau, :878-911)."""
        w = self.F * self.rho_eps0[self.phase]
        norm = w.sum()
        if norm <= 0:
            return jnp.ones(extent.shape[:-1])
        t = jnp.sum((w / norm) * (1.0 - jnp.clip(extent, 0.0, 1.0)), axis=-1)
        return jnp.clip(t, 0.0, 1.0)

    def solid_density(self, extent):
        nph = len(self.rho_eps0)
        x = jnp.clip(extent, 0.0, 1.0)
        # phase_factor[ph] = 1 - sum_{i in ph} F_i x_i
        contrib = jnp.zeros(extent.shape[:-1] + (nph,))
        contrib = contrib.at[..., self.phase].add(self.F * x)
        pf = jnp.maximum(0.0, 1.0 - contrib)
        return jnp.sum(self.rho_eps0 * pf, axis=-1)

    def solid_props(self, T, p, extent, extent_old=None, dt=0.0):
        """EvaluateSolid (:282-402); returns a dict of batched arrays."""
        tau = self.tau(extent)
        rho_s = self.solid_density(extent)
        rho_v = self.rho_virgin
        rho_c = self.rho_char
        rho_ref = jnp.maximum(rho_s, rho_c)
        vw = jnp.where(rho_ref > 0, tau * rho_v / rho_ref, tau)

        # one one-hot contraction per table (eval_props): per-property
        # eval calls batch into a broadcast dot that OOMs at scale
        cp_v, h_v, k_v = self.virgin.eval_props((0, 1, 2), p, T)
        cp_c, h_c, k_c = self.char.eval_props((0, 1, 2), p, T)

        out = {
            "tau": tau,
            "rho_s": rho_s,
            "cp": cp_v * vw + cp_c * (1 - vw),
            "h": h_v * vw + h_c * (1 - vw),
            "k": k_v * vw + k_c * (1 - vw),
        }
        if self.virgin_optics is not None and self.char_optics is not None:
            eps_v, refl_v = self.virgin_optics.eval_props((0, 1), p, T)
            eps_c, refl_c = self.char_optics.eval_props((0, 1), p, T)
            out["emissivity"] = jnp.clip(eps_v * vw + eps_c * (1 - vw),
                                         0.0, 1.0)
            out["reflectivity"] = jnp.clip(refl_v * vw + refl_c * (1 - vw),
                                           0.0, 1.0)
        else:
            out["emissivity"] = jnp.full_like(tau, self.emissivity_fallback)
            out["reflectivity"] = jnp.full_like(tau,
                                                self.reflectivity_fallback)
        out["absorptivity"] = jnp.clip(1.0 - out["reflectivity"], 0.0, 1.0)
        out["K"] = tau * self.K_v + (1 - tau) * self.K_c
        out["eps_g"] = tau * self.eps_g_v + (1 - tau) * self.eps_g_c

        if extent_old is not None:
            x = jnp.clip(extent, 0.0, 1.0)
            xo = jnp.clip(extent_old, 0.0, 1.0)
            dX = jnp.maximum(0.0, x - xo)
            pi = jnp.where(dt > 0,
                           self.rho_eps0[self.phase] * self.F * dX
                           / jnp.maximum(dt, 1e-300), 0.0)
            pi = jnp.where(pi < self.min_pi_pyro, 0.0, pi)
            out["pi_i"] = pi
            out["pi_total"] = pi.sum(axis=-1)
        else:
            out["pi_i"] = jnp.zeros(tau.shape + (self.num_reactions,))
            out["pi_total"] = jnp.zeros_like(tau)

        if abs(rho_v - rho_c) > 1e-14:
            h_bar = (rho_v * h_v - rho_c * h_c) / (rho_v - rho_c)
        else:
            h_bar = h_v
        out["pyrolysis_heat_sink"] = h_bar * out["pi_total"]
        out["m_dot_g"] = out["pi_total"]
        return out

    def gas_props(self, T, p):
        """EvaluateGas (:404-419)."""
        M, h, mu = self.gas.eval_props((0, 1, 2), p, T)
        rho = p * M / (self.R * jnp.maximum(T, 1.0))
        return {"M": M, "h": h, "mu": mu, "rho": rho}
