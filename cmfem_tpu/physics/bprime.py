"""B' surface-thermochemistry table: 3-axis (p, B'g, T) lookup.

Clean-room re-implementation of the reference's ``BPrimeTable``
(/root/reference/myapps/convection_diffusion/bprime_table.{hpp,cpp}):
whitespace table parsing grouping p -> B'g -> (T, B'c, h_w) rows
(LoadFromFile :147-251), natural cubic splines in T per (p, B'g) level,
linear interpolation in B'g, **log-linear in p** (:469-478), derivatives
d/dB'g and d/dT with clamp and non-smoothness flags, and mutable clamp
statistics (ClampStats).

JAX port: levels are stored as padded (Lp, Lbg, nTmax) arrays but each
level evaluates on ITS OWN T knots (ragged per-level rows supported, as
real PATO decks commonly are); lookups are batched jnp ops
differentiable in (B'g, T).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from .tacot import natural_spline_y2, spline_eval


@dataclass
class ClampStats:
    p: int = 0
    bg: int = 0
    t: int = 0


@dataclass
class BPrimeTable:
    p_levels: np.ndarray       # (Lp,)
    bg_levels: np.ndarray      # (Lbg,) shared across p levels
    T_tab: np.ndarray          # (Lp, Lbg, nTmax) per-level T knots (padded)
    T_hi: np.ndarray           # (Lp, Lbg) true top knot per level
    bc: np.ndarray             # (Lp, Lbg, nTmax)
    hw: np.ndarray             # (Lp, Lbg, nTmax)
    bc2: np.ndarray            # spline second derivatives (0 on padding)
    hw2: np.ndarray
    uniform: bool = True       # every level shares identical T knots
    clamp_stats: ClampStats = field(default_factory=ClampStats)

    @property
    def T(self):
        """Shared T grid for uniform tables; level (0,0)'s knots
        otherwise (ragged tables have no shared grid)."""
        return self.T_tab[0, 0]

    @classmethod
    def load_file(cls, path: str) -> "BPrimeTable":
        """Parse the whitespace PATO format: p bg bc T hw per row, //-comments."""
        rows = []
        with open(path) as f:
            for line in f:
                line = line.split("//")[0]
                parts = line.split()
                if len(parts) < 5:
                    continue
                try:
                    vals = [float(v) for v in parts[:5]]
                except ValueError:
                    continue
                rows.append(vals)
        if not rows:
            raise ValueError(f"B-prime table contains no readable data: {path}")
        arr = np.asarray(rows)  # columns: p, bg, bc, T, hw
        return cls.from_rows(arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3], arr[:, 4])

    @classmethod
    def from_rows(cls, p, bg, bc, T, hw) -> "BPrimeTable":
        """Group rows into (p, B'g) levels; every level keeps ITS OWN
        sorted T knots.  Ragged tables — per-level T rows of different
        counts/positions, the common shape of real PATO B' decks — are
        supported exactly as the reference builds them: one cubic
        spline per level over that level's rows
        (bprime_table.cpp:253-371).  Levels are padded to the longest
        row with a monotone knot extension carrying the end value
        (y2=0); lookups clamp the query to each level's TRUE T range,
        so padded knots are never evaluated."""
        p = np.asarray(p); bg = np.asarray(bg)
        bc = np.asarray(bc); T = np.asarray(T); hw = np.asarray(hw)
        ps = np.unique(p)
        bgs = np.unique(bg)
        Lp, Lbg = len(ps), len(bgs)
        levels = {}
        nTmax = 0
        for i, pv in enumerate(ps):
            for j, bgv in enumerate(bgs):
                sel = (p == pv) & (bg == bgv)
                if not sel.any():
                    raise ValueError(
                        "B' table must have every (p, B'g) combination "
                        f"(missing p={pv}, B'g={bgv})")
                Tsel = T[sel]
                order = np.argsort(Tsel)
                Tu, idx = np.unique(Tsel[order], return_index=True)
                if len(Tu) < 2:
                    raise ValueError(
                        f"B' level (p={pv}, B'g={bgv}) needs >= 2 T rows")
                levels[i, j] = (Tu, bc[sel][order][idx],
                                hw[sel][order][idx])
                nTmax = max(nTmax, len(Tu))
        T_tab = np.zeros((Lp, Lbg, nTmax))
        T_hi = np.zeros((Lp, Lbg))
        bc_t = np.zeros((Lp, Lbg, nTmax))
        hw_t = np.zeros((Lp, Lbg, nTmax))
        bc2 = np.zeros((Lp, Lbg, nTmax))
        hw2 = np.zeros((Lp, Lbg, nTmax))
        T00 = levels[0, 0][0]
        uniform = True
        for (i, j), (Tu, bcu, hwu) in levels.items():
            nTl = len(Tu)
            npad = nTmax - nTl
            uniform &= (nTl == len(T00)) and bool(np.allclose(Tu, T00))
            T_hi[i, j] = Tu[-1]
            dpad = Tu[-1] - Tu[-2]
            T_tab[i, j] = np.concatenate(
                [Tu, Tu[-1] + dpad * np.arange(1, npad + 1)])
            bc_t[i, j] = np.concatenate([bcu, np.full(npad, bcu[-1])])
            hw_t[i, j] = np.concatenate([hwu, np.full(npad, hwu[-1])])
            bc2[i, j, :nTl] = natural_spline_y2(Tu, bcu)
            hw2[i, j, :nTl] = natural_spline_y2(Tu, hwu)
        return cls(ps, bgs, T_tab, T_hi, bc_t, hw_t, bc2, hw2,
                   uniform=uniform)

    @classmethod
    def synthetic_tacot(cls) -> "BPrimeTable":
        """A physically-shaped synthetic TACOT-in-air B' table for testing
        when the PATO data deck is unavailable (the reference points at an
        author-local absolute path).  B'c ramps smoothly from the
        oxidation plateau (~0.17) to the sublimation regime above ~3000 K,
        decreasing with B'g dilution; h_w grows roughly like hot-gas
        enthalpy.  NOT validation data — shapes only."""
        ps = np.array([1013.25, 10132.5, 101325.0])
        bgs = np.array([1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0])
        Ts = np.linspace(200.0, 4000.0, 96)
        bc = np.zeros((len(ps), len(bgs), len(Ts)))
        hw = np.zeros_like(bc)
        for i, p in enumerate(ps):
            for j, bg in enumerate(bgs):
                T_ox = 1200.0 + 60.0 * np.log10(p / 101325.0 + 1e-12)
                plateau = 0.17 / (1.0 + bg)
                subl_T = 3200.0 + 80.0 * np.log10(p / 1013.25)
                ox = plateau / (1.0 + np.exp(-(Ts - T_ox) / 80.0))
                subl = 2.0 / (1.0 + np.exp(-(Ts - subl_T) / 60.0))
                bc[i, j] = ox + subl
                hw[i, j] = 1.1e3 * (Ts - 298.0) + 0.12 * (Ts - 298.0) ** 2 \
                    - 4.0e5 * bg / (1.0 + bg)
        P, BG, TT = np.meshgrid(ps, bgs, Ts, indexing="ij")
        return cls.from_rows(P.ravel(), BG.ravel(), bc.ravel(),
                             TT.ravel(), hw.ravel())

    # -- lookup ------------------------------------------------------------

    def lookup(self, p, bg, T, count_clamps: bool = False):
        """Batched lookup.

        Returns dict(bc, hw, dbc_dbg, dbc_dT, dhw_dbg, dhw_dT, clamped_p,
        clamped_bg, clamped_t, nonsmooth_bg); all jnp arrays broadcast
        from (p, bg, T)."""
        ps = self.p_levels
        bgs = self.bg_levels
        Lp, Lbg = len(ps), len(bgs)
        p = jnp.asarray(p)
        bg = jnp.asarray(bg)
        T = jnp.asarray(T)

        # evaluate splines at all (p, bg) levels: (Lp, Lbg, ...).
        # UNIFORM tables evaluate on the one SHARED grid so the interval
        # search/one-hot is a common subexpression across the Lp*Lbg
        # unrolled evals (XLA CSEs it once); ragged tables clamp the
        # query to each level's TRUE T range (padding knots never
        # evaluated) with clamp-flag/zero-derivative semantics imposed
        # per level (EvalClampWithDerivative).
        T_shared = jnp.asarray(self.T_tab[0, 0]) if self.uniform else None

        def eval_all(y, y2):
            vals = []
            ders = []
            cls_ = []
            for i in range(Lp):
                vi, di, ci = [], [], []
                for j in range(Lbg):
                    if self.uniform:
                        v, d, c = spline_eval(T_shared,
                                              jnp.asarray(y[i, j]),
                                              jnp.asarray(y2[i, j]), T)
                    else:
                        lo = self.T_tab[i, j, 0]
                        hi = self.T_hi[i, j]
                        Tq = jnp.clip(T, lo, hi)
                        v, d, _ = spline_eval(
                            jnp.asarray(self.T_tab[i, j]),
                            jnp.asarray(y[i, j]),
                            jnp.asarray(y2[i, j]), Tq)
                        c = (T < lo) | (T > hi)
                        d = jnp.where(c, 0.0, d)
                    vi.append(v); di.append(d); ci.append(c)
                vals.append(jnp.stack(vi)); ders.append(jnp.stack(di))
                cls_.append(jnp.stack(ci))
            return jnp.stack(vals), jnp.stack(ders), jnp.stack(cls_)

        bc_v, bc_d, bc_c = eval_all(self.bc, self.bc2)
        hw_v, hw_d, hw_c = eval_all(self.hw, self.hw2)

        # B'g axis: clamp + linear
        bg_min, bg_max = bgs[0], bgs[-1]
        bg_q = jnp.clip(bg, bg_min, bg_max)
        clamped_bg = (bg < bg_min) | (bg > bg_max)
        bgs_j = jnp.asarray(bgs)
        # vectorized-comparison interval + one-hot selection (see
        # tacot.spline_eval)
        hj = jnp.clip(jnp.sum(bg_q[..., None] > bgs_j, axis=-1), 1, Lbg - 1)
        lj = hj - 1
        oh_lj = (lj[..., None] == jnp.arange(Lbg))
        oh_hj = (hj[..., None] == jnp.arange(Lbg))
        bg0 = jnp.sum(bgs_j * oh_lj, axis=-1)
        bg1 = jnp.sum(bgs_j * oh_hj, axis=-1)
        wbg = (bg_q - bg0) / (bg1 - bg0)
        on_node = (jnp.abs(bg_q - bg0) <= 1e-12 * jnp.maximum(1.0, jnp.abs(bg_q))) | \
                  (jnp.abs(bg_q - bg1) <= 1e-12 * jnp.maximum(1.0, jnp.abs(bg_q)))
        nonsmooth_bg = clamped_bg | on_node

        def sel_bg(a, oh):
            # a (Lp, Lbg, ...) one-hot contracted over the Lbg axis
            am = jnp.moveaxis(a, 1, -1)             # (Lp, ..., Lbg)
            return jnp.sum(am * oh.astype(am.dtype), axis=-1)

        def interp_bg(vals, ders):
            v0 = sel_bg(vals, oh_lj)
            v1 = sel_bg(vals, oh_hj)
            d0 = sel_bg(ders, oh_lj)
            d1 = sel_bg(ders, oh_hj)
            val = (1 - wbg) * v0 + wbg * v1
            dT = (1 - wbg) * d0 + wbg * d1
            dbg = jnp.where(clamped_bg, 0.0, (v1 - v0) / (bg1 - bg0))
            return val, dT, dbg

        bc_p, bc_dT_p, bc_dbg_p = interp_bg(bc_v, bc_d)
        hw_p, hw_dT_p, hw_dbg_p = interp_bg(hw_v, hw_d)
        clamped_t = jnp.any(bc_c | hw_c, axis=(0, 1))

        # pressure axis: clamp + log-linear
        p_min, p_max = ps[0], ps[-1]
        p_q = jnp.clip(p, p_min, p_max)
        clamped_p = (p < p_min) | (p > p_max)
        if Lp == 1:
            out_sel = lambda a: a[0]
            bc_o, hw_o = out_sel(bc_p), out_sel(hw_p)
            bc_dT, hw_dT = out_sel(bc_dT_p), out_sel(hw_dT_p)
            bc_dbg, hw_dbg = out_sel(bc_dbg_p), out_sel(hw_dbg_p)
        else:
            ps_j = jnp.asarray(ps)
            hi = jnp.clip(jnp.sum(p_q[..., None] > ps_j, axis=-1), 1,
                          Lp - 1)
            lo = hi - 1
            oh_lo = (lo[..., None] == jnp.arange(Lp))
            oh_hi = (hi[..., None] == jnp.arange(Lp))
            lp0 = jnp.log(jnp.maximum(jnp.sum(ps_j * oh_lo, axis=-1),
                                      1e-30))
            lp1 = jnp.log(jnp.maximum(jnp.sum(ps_j * oh_hi, axis=-1),
                                      1e-30))
            lpq = jnp.log(jnp.maximum(p_q, 1e-30))
            w = (lpq - lp0) / (lp1 - lp0)

            def mix(a):
                am = jnp.moveaxis(a, 0, -1)          # (..., Lp)
                a0 = jnp.sum(am * oh_lo.astype(am.dtype), axis=-1)
                a1 = jnp.sum(am * oh_hi.astype(am.dtype), axis=-1)
                return (1 - w) * a0 + w * a1

            bc_o, hw_o = mix(bc_p), mix(hw_p)
            bc_dT, hw_dT = mix(bc_dT_p), mix(hw_dT_p)
            bc_dbg, hw_dbg = mix(bc_dbg_p), mix(hw_dbg_p)

        if count_clamps:
            self.clamp_stats.p += int(np.sum(np.asarray(clamped_p)))
            self.clamp_stats.bg += int(np.sum(np.asarray(clamped_bg)))
            self.clamp_stats.t += int(np.sum(np.asarray(clamped_t)))

        return {
            "bc": bc_o, "hw": hw_o,
            "dbc_dbg": bc_dbg, "dbc_dT": bc_dT,
            "dhw_dbg": hw_dbg, "dhw_dT": hw_dT,
            "clamped_p": clamped_p, "clamped_bg": clamped_bg,
            "clamped_t": clamped_t, "nonsmooth_bg": nonsmooth_bg,
        }
