"""Shared app-driver scaffolding: CLI, mesh setup, config echo.

Each app mirrors one reference driver: parse `-i input.yaml`, echo config,
build mesh/space, run, write CSV + ParaView (SURVEY.md §1 L5)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..core import load_gmsh, Mesh
from ..utils.yamlcfg import resolve_path


def parse_args(default_input: str, argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", default=default_input, help="YAML input file.")
    return ap.parse_args(argv)


def load_mesh_from_cfg(cfg: dict, expected_dim: int = 2) -> Mesh:
    mesh_file = cfg.get("mesh_file")
    if not mesh_file:
        raise KeyError("Missing required YAML key: mesh_file")
    mesh = load_gmsh(resolve_path(cfg, mesh_file))
    if mesh.dim != expected_dim:
        raise ValueError(f"The mesh must be {expected_dim}D.")
    levels = int(cfg.get("serial_ref_levels", 0)) + int(cfg.get("par_ref_levels", 0))
    if levels:
        mesh = mesh.uniform_refine(levels)
    return mesh


def make_mg_preconditioner(cfg, order, make_form, ess_dofs=None):
    """Geometric-multigrid preconditioner for a driver's linear solves
    (``linear_solver: mg`` — VERDICT r4 #7: wired into diffusion_mms,
    linear_cd_2d, AND linear_cd_transient; the reference's petsc*.opts
    PC-configuration analog).

    Re-derives the driver's own refinement chain from the cfg
    (serial_ref_levels + par_ref_levels), p-coarsens order>1 to 1 on
    the finest mesh, then h-coarsens down the chain.  ``make_form``
    builds the level bilinear form from a level SpaceOps."""
    from ..solvers import GeometricMG

    base = load_mesh_from_cfg(
        {**cfg, "serial_ref_levels": 0, "par_ref_levels": 0})
    nref = int(cfg.get("serial_ref_levels", 0)) \
        + int(cfg.get("par_ref_levels", 0))
    if nref < 1 and order < 2:
        raise ValueError(
            "linear_solver: mg needs a hierarchy — set "
            "serial_ref_levels >= 1 and/or order >= 2")
    chain = [base]
    for _ in range(nref):
        chain.insert(0, chain[0].uniform_refine(1))
    specs = [(chain[0], order)]
    if order > 1:
        specs.append((chain[0], 1))
    specs += [(m, 1) for m in chain[1:]]
    mg = GeometricMG.build(specs, make_form, ess_dofs=ess_dofs)
    Mmg, mg_arrays = mg.bind()
    print(f"MG hierarchy: {len(specs)} levels "
          f"({[s[0].num_elements for s in specs]} elems at orders "
          f"{[s[1] for s in specs]})")
    return lambda r: Mmg(r, mg_arrays)


def echo_config(cfg_obj, title="Loaded configuration:"):
    print(title)
    for k, v in cfg_obj.items() if isinstance(cfg_obj, dict) else vars(cfg_obj).items():
        if k.startswith("_"):
            continue
        print(f"  {k}: {v}")


def ensure_outdir(path: str):
    os.makedirs(path, exist_ok=True)
    return path


def validate_unit_square(mesh: Mesh, tol=1e-8):
    lo, hi = mesh.bounding_box()
    if not (abs(lo[0]) <= tol and abs(hi[0] - 1) <= tol
            and abs(lo[1]) <= tol and abs(hi[1] - 1) <= tol):
        raise ValueError(
            f"Mesh coordinates must span approximately [0,1]x[0,1]. "
            f"Got x=[{lo[0]},{hi[0]}], y=[{lo[1]},{hi[1]}]."
        )


def validate_unit_circle(mesh: Mesh, tol=1e-6):
    r = np.linalg.norm(mesh.vertices, axis=1).max()
    if abs(r - 1.0) > tol:
        raise ValueError(f"Expected unit-circle mesh (max radius near 1). "
                         f"Found max radius {r}.")


def validate_square(mesh: Mesh, tol=1e-8):
    lo, hi = mesh.bounding_box()
    lx, ly = hi[0] - lo[0], hi[1] - lo[1]
    scale = max(abs(lx), abs(ly), 1.0)
    if lx <= tol or ly <= tol or abs(lx - ly) > 1e-8 * scale + tol:
        raise ValueError(f"Mesh must be square (equal x/y extents). "
                         f"Got lx={lx}, ly={ly}.")


def x_boundary_attrs(mesh: Mesh, tol=1e-8):
    """Attributes of boundary faces lying on the x-extremes (the transient
    driver's geometric Dirichlet detection,
    linear_convection_diffusion_1D.cpp:214-258)."""
    lo, hi = mesh.bounding_box()
    centers = mesh.vertices[mesh.bdr_conn].mean(axis=1)
    on_x = (np.abs(centers[:, 0] - lo[0]) <= tol) | (np.abs(centers[:, 0] - hi[0]) <= tol)
    return sorted(set(mesh.bdr_attr[on_x].tolist()))


def y_boundary_attrs(mesh: Mesh, tol=1e-8):
    lo, hi = mesh.bounding_box()
    centers = mesh.vertices[mesh.bdr_conn].mean(axis=1)
    on_y = (np.abs(centers[:, 1] - lo[1]) <= tol) | (np.abs(centers[:, 1] - hi[1]) <= tol)
    return sorted(set(mesh.bdr_attr[on_y].tolist()))


def num_steps(t_final: float, dt: float) -> int:
    """ceil(t_final/dt - 1e-12), as in the reference drivers."""
    import math

    return int(math.ceil(t_final / dt - 1.0e-12))


_lin_warnings = {"count": 0}

# Inexact-Newton forcing: a Krylov direction whose PRECONDITIONED
# relative residual is below eta reduces the linearized residual by
# that factor, which is all an outer Newton step needs (Eisenstat &
# Walker: any eta < 1 preserves local convergence; 1e-2 keeps it
# near-quadratic).  Used to arbitrate solves that hit the cycle cap
# while still progressing — the f32-chip regime where the deck's f64
# rtol is clamped to the 16 eps floor and GMRES may grind toward it
# at >10%/cycle without arriving within gmres_maxiter cycles.
LINEAR_FORCING_ETA = 1.0e-2

# Acceptance bound for STANDALONE stagnated solves: a linear driver with
# no outer Newton arbiter may accept a stagnation-window exit only when
# the achieved true relative residual is below this floor — loose enough
# for the f32 precision floor (~100s of eps after conditioning), tight
# enough that a defeated preconditioner stalling at rel ~1e-1 raises
# instead of silently producing wrong error metrics (ADVICE r3 #3).
STAGNATION_ACCEPT_REL = 1.0e-3


def linear_usable(sol, eta: float = LINEAR_FORCING_ETA):
    """Jittable: is this SolveResult a Newton-usable direction?
    converged | stagnated-at-floor | inexact-Newton forcing met."""
    rel = getattr(sol, "rel_residual", -1.0)
    return (sol.converged | getattr(sol, "stagnated", False)
            | ((rel >= 0) & (rel < eta)))


def check_linear_result(res, what: str):
    """Arbitrate an iterative linear SolveResult inside a Newton loop.

    converged -> fine.  stagnated (a full GMRES cycle improved the true
    residual <10% — the working-precision floor on f32 chips, or a
    defeated preconditioner) or cycle-cap-with-forcing-met (preconditioned
    rel residual < LINEAR_FORCING_ETA, an exact-enough inexact-Newton
    direction) -> accept the iterate with a rate-limited warning; the
    OUTER Newton convergence check is the arbiter of whether the solve
    was good enough (reference analog: MUMPS LU never reports failure
    either — newton_petsc_solver.hpp:354-362's KSP check exists to catch
    silent Krylov failure, which Newton's own residual test subsumes
    here).  Neither -> fail fast with the tuning hint."""
    if bool(res.converged):
        return
    rel = float(getattr(res, "rel_residual", -1.0))
    if bool(getattr(res, "stagnated", False)) or 0 <= rel < LINEAR_FORCING_ETA:
        _lin_warnings["count"] += 1
        if _lin_warnings["count"] <= 3:
            print(f"WARNING: {what} stopped above tol at residual "
                  f"{float(res.residual):.3e} (rel {rel:.1e}) after "
                  f"{int(res.iters)} cycles (working-precision floor or "
                  "cycle cap with forcing met); Newton's residual test "
                  "arbitrates.")
        return
    raise RuntimeError(
        f"{what} did not converge: residual {float(res.residual):.3e} "
        f"after {int(res.iters)} restart cycles "
        "(raise gmres_restart/gmres_maxiter)")


def check_standalone_linear(res, what="Linear solver"):
    """Fail-fast convergence check for the standalone (non-Newton) linear
    drivers (reference analog: the PETSc KSP verification at
    linear_convection_diffusion_2D.cpp:371-374).  ``converged`` passes.
    ``stagnated`` — a full Krylov cycle improved the TRUE residual by
    <10%, i.e. the iteration sits on the working-precision floor of the
    arithmetic — also passes, with a warning: the reference decks carry
    f64 tolerances (rtol 1e-10..1e-12) that are unreachable in the f32
    on-chip regime, where the floored iterate IS the converged answer to
    working precision.  Anything else (cycle cap while still progressing)
    raises with the tuning hint."""
    if bool(res.converged):
        return
    rel = float(getattr(res, "rel_residual", -1.0))
    if bool(getattr(res, "stagnated", False)):
        # a stagnated iterate is only acceptable if it actually SOLVED
        # the system to within a loose precision-floor bound: plain slow
        # convergence (a defeated preconditioner stalling at rel ~1e-1)
        # also trips the stagnation window, and silently accepting it
        # hands the driver a wrong solution (ADVICE r3 #3)
        if 0.0 <= rel <= STAGNATION_ACCEPT_REL:
            print(f"WARNING: {what} stopped at the working-precision "
                  f"floor: residual {float(res.residual):.3e} "
                  f"(rel {rel:.1e}) after {int(res.iters)} iterations "
                  "(deck rtol targets the f64 regime).")
            return
        raise RuntimeError(
            f"{what} stagnated ABOVE the acceptance floor: rel residual "
            f"{rel:.3e} > {STAGNATION_ACCEPT_REL:.1e} after "
            f"{int(res.iters)} iterations — the preconditioner is "
            "defeated or the system is inconsistent; this is not a "
            "working-precision floor (improve the preconditioner or "
            "raise solver_maxiter)")
    raise RuntimeError(
        f"{what} did not converge. Iterations={int(res.iters)}, "
        f"residual={float(res.residual)} "
        "(raise solver_maxiter/solver_restart)")


def load_newton_config(cfg: dict, *, abs_tol=1e-8, rel_tol=1e-6,
                       max_iter=20):
    """NewtonConfig from the reference YAML keys plus the
    working-precision stall-exit knobs (newton_stall_improve /
    newton_stall_patience / newton_stall_accept_rel; see
    solvers.newton.NewtonConfig — newton_stall_accept_rel: 0 disables)."""
    from ..solvers.newton import NewtonConfig

    return NewtonConfig(
        abs_tol=float(cfg.get("newton_abs_tol", abs_tol)),
        rel_tol=float(cfg.get("newton_rel_tol", rel_tol)),
        max_iter=int(cfg.get("newton_max_iter", max_iter)),
        stall_improve=float(cfg.get("newton_stall_improve", 1e-3)),
        stall_patience=int(cfg.get("newton_stall_patience", 2)),
        stall_accept_rel=float(cfg.get("newton_stall_accept_rel", 1e-3)),
        stall_dx_rtol=cfg.get("newton_stall_dx_rtol", None),
        stall_flat_factor=float(cfg.get("newton_stall_flat_factor", 1.15)),
    )


def scan_newton(T, p, *, residual, solve, abs_tol, rel_tol, max_iter,
                stall_improve=1e-3, stall_patience=2,
                stall_accept_rel=1e-3, stall_dx_rtol=None,
                stall_flat_factor=1.15):
    """Jittable Newton ``lax.while_loop`` shared by the three ablation
    scan paths (the device-resident analog of ``run_tp_newton_loop``).

    ``residual(T, p) -> R`` (BC-masked stacked residual) and
    ``solve(T, p, R) -> (T_new, p_new, |dx|, lin_ok)`` close over the
    step's frozen inputs.  Reference semantics — r0 = max(1, |R0|),
    abs/rel tolerance, at most ``max_iter`` residual checks/solves
    (newton_petsc_solver.hpp:166-268) — plus the working-precision
    stall exit of ``NewtonConfig``: on the f32 chip the residual floors
    near rel ~1e-5 (measured on the case-1 production deck) while the
    decks carry f64 tolerances; without the exit every step burns all
    ``max_iter`` iterations and a 200-step scan chunk becomes hours of
    device time in one XLA program.
    A diverging solve (rel >= stall_accept_rel) never stall-exits: it
    runs to max_iter and reports done=False, preserving fail-fast.

    Three stall-acceptance criteria, any suffices (all gated on
    stall_patience consecutive non-improving residuals):
      (a) rn/r0 < stall_accept_rel — the step made real progress first;
      (b) |dx| <= stall_dx_rtol * |[T;p]| (default 30 eps of the
          working dtype) — the Newton UPDATE is numerically negligible,
          which covers steps that START at the floor (r0 ~ rn, rel ~ 1,
          e.g. a quiescent step after the surface ramp completes) where
          (a) can never fire;
      (c) the residual has been FLAT at its best value for the whole
          non-improving window: max(residuals since the last
          improvement) <= stall_flat_factor * rbest, where rbest is the
          best BEFORE this iteration's residual is absorbed, AND every
          linear solve so far was usable (lin_ok).  At small dt the BE
          storage terms amplify f32 rounding by 1/dt while the per-step
          signal shrinks by dt, so the f32 evaluation floor sits only a
          few times below R0 (the production case-2.2 deck at dt=0.0025
          floors at rel ~0.22 while the f64 oracle reaches 3e-9 on the
          same step): after one good linear solve the iterate IS the f64
          Newton iterate to working precision and neither (a) nor (b)
          can ever fire.  Tracking the window MAXIMUM (not just the
          latest rn) means an oscillating divergence (1.0, 5.0, 1.1)
          never flat-exits on the dip, and the lin_ok gate keeps the
          'after one good linear solve' justification honest
          (ADVICE r3 #2).  Set stall_flat_factor <= 1 to disable
          criterion (c) entirely.

    Returns (T, p, iters, r0, rn, done, res_history, update_history,
    linear_ok, stalled) with NaN-padded fixed-length histories for the
    newton CSV replay; ``stalled`` is True when ``done`` came from a
    stall-acceptance exit rather than the abs/rel tolerance, so drivers
    can count and surface floor-accepted steps distinctly."""
    import jax
    import jax.numpy as jnp

    if stall_dx_rtol is None:
        stall_dx_rtol = 30.0 * float(jnp.finfo(
            jnp.result_type(T)).eps)
    flat_enabled = float(stall_flat_factor) > 1.0

    def nw_cond(st):
        return (~st[5]) & (st[2] < max_iter)

    def nw_body(st):
        (T, p, it, r0, _, _, res_h, upd_h, lin_ok, rbest, noimp,
         un_prev, rmax, was_stalled) = st
        R = residual(T, p)
        rn = jnp.linalg.norm(R)
        r0 = jnp.where(it == 0, jnp.maximum(1.0, rn), r0)
        rbest_pre = rbest
        improved = rn < (1.0 - stall_improve) * rbest
        noimp = jnp.where(improved, 0, noimp + 1)
        # max residual over the current non-improving window
        rmax = jnp.where(improved, rn, jnp.maximum(rmax, rn))
        rbest = jnp.minimum(rbest, rn)
        xnorm = jnp.sqrt(jnp.sum(T * T) + jnp.sum(p * p))
        flat_ok = (lin_ok & (rmax <= stall_flat_factor * rbest_pre)
                   if flat_enabled else jnp.asarray(False))
        stalled = (noimp >= stall_patience) & (
            (rn / r0 < stall_accept_rel)
            | (un_prev <= stall_dx_rtol * xnorm)
            | flat_ok)
        tol_done = (rn < abs_tol) | (rn / r0 < rel_tol)
        done = tol_done | stalled
        was_stalled = was_stalled | (stalled & ~tol_done)
        res_h = res_h.at[it].set(rn)

        T, p, un, ok = jax.lax.cond(
            done, lambda tp: (tp[0], tp[1], 0.0, True),
            lambda tp: solve(tp[0], tp[1], R), (T, p))
        upd_h = upd_h.at[it].set(jnp.where(done, jnp.nan, un))
        return (T, p, it + 1, r0, rn, done, res_h, upd_h, lin_ok & ok,
                rbest, noimp, jnp.where(done, un_prev, un), rmax,
                was_stalled)

    nanh = jnp.full(max_iter + 1, jnp.nan)
    out = jax.lax.while_loop(
        nw_cond, nw_body,
        (T, p, 0, 1.0, jnp.inf, False, nanh, nanh, True, jnp.inf, 0,
         jnp.inf, jnp.inf, False))
    return out[:9] + (out[13],)


def replay_newton_history(newton_csv, gstep, tk, nit, r0k, res_h, upd_h):
    """Replay one scan step's recorded Newton iterate history into the
    newton CSV (NaN marks unused history slots; the single implementation
    behind the case-1 and case-2.2 scan paths' post-chunk replays)."""
    du0 = max(1.0, float(upd_h[0])) if np.isfinite(upd_h[0]) else 1.0
    for i in range(nit + 1):
        rk = res_h[i]
        if not np.isfinite(rk):
            break
        uk = upd_h[i]
        conv = 1 if (i == nit or not np.isfinite(uk)) else 0
        un = 0.0 if not np.isfinite(uk) else float(uk)
        newton_csv.writerow([gstep, tk, i, float(rk), r0k,
                             float(rk) / r0k, un, du0, un / du0, conv])


class NewtonStallStats:
    """Accumulates per-step Newton stall-exit statistics across scan
    chunks (VERDICT r4 #9): how many steps were accepted at the
    working-precision stall floor rather than the abs/rel tolerance,
    and the distribution of those steps' final relative residuals —
    so f32 floor-acceptance stays observable in full-run artifacts."""

    def __init__(self):
        self.steps = 0
        self.stalled = 0
        self._rels = []

    def update(self, nw_stalls, rns, r0s):
        m = np.asarray(nw_stalls, dtype=bool)
        self.steps += int(m.size)
        self.stalled += int(m.sum())
        if m.any():
            rel = np.asarray(rns, dtype=float)[m] \
                / np.maximum(np.asarray(r0s, dtype=float)[m], 1e-300)
            self._rels.extend(rel.tolist())

    def summary(self):
        out = {"newton_steps": self.steps,
               "newton_stalled_steps": self.stalled,
               "newton_stalled_frac": round(
                   self.stalled / max(1, self.steps), 5)}
        if self._rels:
            r = np.asarray(self._rels)
            out["stalled_rel_residual"] = {
                "min": float(r.min()),
                "p50": float(np.percentile(r, 50)),
                "p90": float(np.percentile(r, 90)),
                "max": float(r.max())}
        return out


def run_tp_newton_loop(T, p, *, residual, factorize, enforce_bc,
                       newton_cfg, rebuild_freq, newton_csv, step, t, n,
                       print_level=0, print_multiline=True):
    """The shared damped-free Newton loop of the three ablation drivers
    (PetscNewtonSolver::SolveImpl semantics, newton_petsc_solver.hpp:166-268:
    r0 = max(1, |R0|), abs/rel tolerance, Jacobian rebuild frequency, BC
    re-enforcement after every update, per-iteration CSV logging).

    residual(T, p) -> R (2n,) BC-masked stacked residual;
    factorize(T, p) -> object with .solve(rhs) -> np.ndarray (host LU or
    on-device block GMRES — see make_block_linear_solver);
    enforce_bc(T, p) -> (T, p) re-pinning essential values.

    Newton CSV row schema (all three drivers):
    [step, t, it, |R|, r0, |R|/r0, |du|, du0, |du|/du0, converged].

    Returns (T, p, iters, timing) with timing keys nres/njac/nlin/nupd;
    raises RuntimeError on non-convergence (fail-fast, SURVEY.md §5.3).
    """
    import time as _time

    import jax
    import jax.numpy as jnp

    nres = njac = nlin = nupd = 0.0
    r0 = du0 = 1.0
    converged = False
    iters = 0
    final_res = np.inf
    lu = None
    rbest = np.inf
    rmax = np.inf
    noimp = 0
    un_prev = np.inf
    stall_improve = getattr(newton_cfg, "stall_improve", 1e-3)
    stall_patience = getattr(newton_cfg, "stall_patience", 2)
    stall_accept = getattr(newton_cfg, "stall_accept_rel", 1e-3)
    stall_flat = getattr(newton_cfg, "stall_flat_factor", 1.15)
    flat_enabled = float(stall_flat) > 1.0
    stall_dx_rtol = getattr(newton_cfg, "stall_dx_rtol", None)
    if stall_dx_rtol is None:
        stall_dx_rtol = 30.0 * float(jnp.finfo(jnp.result_type(T)).eps)
    for it in range(newton_cfg.max_iter):
        tt = _time.perf_counter()
        R = residual(T, p)
        R = jax.block_until_ready(R)
        nres += _time.perf_counter() - tt
        res_norm = float(jnp.linalg.norm(R))
        if it == 0:
            r0 = max(1.0, res_norm)
        rel_res = res_norm / r0
        final_res = res_norm
        # same flat-stall semantics as scan_newton / newton_solve
        # (ADVICE r3 #2): window MAXIMUM vs the pre-update best, so an
        # oscillating divergence never flat-exits on a dip; every linear
        # solve here passed check_linear_result, satisfying the
        # usable-solve gate
        rbest_pre = rbest
        improved = res_norm < (1.0 - stall_improve) * rbest
        noimp = 0 if improved else noimp + 1
        rmax = res_norm if improved else max(rmax, res_norm)
        rbest = min(rbest, res_norm)
        xnorm = float(np.sqrt(float(jnp.sum(T * T)) + float(jnp.sum(p * p))))
        flat_ok = flat_enabled and rmax <= stall_flat * rbest_pre
        stalled = noimp >= stall_patience and (
            rel_res < stall_accept or un_prev <= stall_dx_rtol * xnorm
            or flat_ok)
        if res_norm < newton_cfg.abs_tol or rel_res < newton_cfg.rel_tol \
                or stalled:
            converged = True
            iters = it
            newton_csv.writerow([step, t, it, res_norm, r0, rel_res,
                                 0.0, du0, 0.0, 1])
            break
        if lu is None or it % rebuild_freq == 0:
            tt = _time.perf_counter()
            lu = factorize(T, p)
            njac += _time.perf_counter() - tt
        tt = _time.perf_counter()
        dx = lu.solve(-np.asarray(R))
        nlin += _time.perf_counter() - tt
        tt = _time.perf_counter()
        un = float(np.linalg.norm(dx))
        un_prev = un
        if it == 0:
            du0 = max(1.0, un)
        T = T + jnp.asarray(dx[:n])
        p = p + jnp.asarray(dx[n:])
        T, p = enforce_bc(T, p)
        nupd += _time.perf_counter() - tt
        newton_csv.writerow([step, t, it, res_norm, r0, rel_res,
                             un, du0, un / du0, 0])
        if print_level > 0:
            if print_multiline:
                print(f"NR iteration {it}:\n|R|/|R0|= {rel_res}\n"
                      f"|R|= {res_norm}\n|du|/|du0|= {un / du0}\n|du|= {un}")
            else:
                print(f"NR iteration {it}: |R|/|R0|= {rel_res} "
                      f"|R|= {res_norm}")
    if not converged:
        raise RuntimeError(
            f"Newton did not converge at step {step}, final residual="
            f"{final_res}")
    return T, p, iters, {"nres": nres, "njac": njac, "nlin": nlin,
                         "nupd": nupd}


def make_block_linear_solver(cfg: dict, element_dofs, n, ess_T, ess_p,
                             node_positions=None):
    """Optional on-device iterative solver for the ablation (T,p) Newton
    systems (YAML key ``linear_solver``, SURVEY.md §7.3 direct-solver
    replacement).

    Returns None for the default host sparse-LU path (``lu``, the MUMPS
    analog), or a factory ``factory(blocks, face=None, face_elem=None)``
    producing objects with the same ``.solve(rhs) -> ndarray`` surface as
    ``scipy.sparse.linalg.splu`` so the Newton loops are solver-agnostic.
    Tuning keys: ``linear_rtol`` (default 1e-10), ``gmres_restart`` (400),
    ``gmres_maxiter`` (10 cycles).

    When ``node_positions`` is given and the scalar dofs form a
    tensor-product strip lattice (the reference's transfinite ablation
    meshes), the solver uses the gather-free stencil matvec
    (``gmres_lattice: false`` opts out)."""
    mode = str(cfg.get("linear_solver", "lu")).lower()
    if mode in ("lu", "direct", "mumps"):
        return None
    if mode not in ("gmres", "iterative", "krylov"):
        raise ValueError(
            f"linear_solver must be 'lu' or 'gmres', got {mode!r}")
    import jax.numpy as jnp
    import numpy as np

    from ..solvers import BlockNewtonKrylov
    from ..solvers.blocksolve import strip_dof_lattice

    dof_lattice = None
    if node_positions is not None and bool(cfg.get("gmres_lattice", True)):
        try:
            dof_lattice = strip_dof_lattice(node_positions)
        except ValueError:
            dof_lattice = None

    bks = BlockNewtonKrylov(
        element_dofs, n, ess_T, ess_p,
        restart=int(cfg.get("gmres_restart", 400)),
        maxiter=int(cfg.get("gmres_maxiter", 10)),
        dof_lattice=dof_lattice)
    rtol = float(cfg.get("linear_rtol", 1.0e-10))

    class _Prepared:
        def __init__(self, factors):
            self.factors = factors

        def solve(self, rhs):
            res = bks.solve(self.factors, jnp.asarray(rhs), rtol=rtol)
            check_linear_result(res, "block GMRES")
            return np.asarray(res.x)

    def factory(blocks, face=None, face_elem=None):
        return _Prepared(bks.prepare(blocks, face=face, face_elem=face_elem))

    return factory


def maybe_enable_lattice_residual(cfg: dict, sys_, fes):
    """Opt-in window-slicing ablation residual (YAML ``lattice_residual:
    true``): on tensor-product strip meshes the residual's per-element
    gather/segment_sum becomes static window
    slices (``AblationSystem.set_dof_lattice``).  Explicit opt-in raises
    if the mesh does not qualify rather than silently degrading."""
    if not bool(cfg.get("lattice_residual", False)):
        return False
    from ..solvers.blocksolve import strip_dof_lattice

    sys_.set_dof_lattice(strip_dof_lattice(fes.node_positions))
    print("lattice_residual: window-slicing residual path enabled "
          f"({sys_.lat.NY}x{sys_.lat.NX} dof lattice)")
    return True


def moving_mesh_and_ale_toggles(cfg: dict):
    """Resolve the case-2.2 mesh-motion/ALE switch set with the
    reference's exact composition (ablation_test_case2_2_2D.cpp:357-361,
    :3712; _test.cpp:4409-4416):

      moving_mesh (master)                -> recession machinery at all
      ale_mass_active   = moving_mesh && ale_enabled && ale_mass_enabled
      ale_energy_solid  = moving_mesh && ale_enabled && ale_energy_enabled
                          && ale_energy_solid_enabled
      ale_energy_gas    = moving_mesh && ale_enabled && ale_energy_enabled
                          && ale_energy_gas_enabled

    The ``&& moving_mesh`` gate is explicit (as in _test.cpp:4409-4416)
    rather than relying on the mesh velocity being zero when motion is
    off; both give identical results today because every ALE term is
    linear in the mesh velocity, but the explicit form survives future
    non-linear-in-w terms.

    INTENTIONAL SUPERSET (documented in docs/MIGRATION.md): the reference
    PRODUCTION driver (ablation_test_case2_2_2D.cpp) parses only
    moving_mesh/ale_enabled and silently ignores the per-term keys
    (ale_mass_enabled, ale_energy_*_enabled — those exist only in the
    _test variant, _test.cpp:120-123); here the production driver honors
    them too.  Every reference production config leaves them at their
    defaults (all true), where behavior is identical.

    ``recession_enabled`` (default true) is NOT an alias: it AND-composes
    with ``moving_mesh``, so setting either to false disables mesh
    motion.  (``recession_enabled`` predates the reference-named
    ``moving_mesh`` key in this package and is kept for back-compat.)
    Validates ``mesh_smoothing_model`` like the reference (:483-491)."""
    smoothing = str(cfg.get("mesh_smoothing_model", "laplacian")).lower()
    if smoothing != "laplacian":
        raise ValueError('mesh_smoothing_model must be "laplacian".')
    moving = bool(cfg.get("moving_mesh", True)) \
        and bool(cfg.get("recession_enabled", True))
    ale = moving and bool(cfg.get("ale_enabled", True))
    ale_energy = ale and bool(cfg.get("ale_energy_enabled", True))
    toggles = (ale and bool(cfg.get("ale_mass_enabled", True)),
               ale_energy and bool(cfg.get("ale_energy_solid_enabled", True)),
               ale_energy and bool(cfg.get("ale_energy_gas_enabled", True)))
    return moving, toggles


def maybe_reorder_strip_mesh(cfg: dict, mesh):
    """With ``lattice_residual: true``, renumber strip-mesh elements
    row-major over the cell lattice (ops/lattice2d.strip_element_order) so
    the window-slicing residual path qualifies; GMSH transfinite meshes
    enumerate elements in generator order.  No-op for other configs or
    non-tensor meshes (the residual opt-in will then raise with a clear
    message).  Must run BEFORE any per-element state is built."""
    if not bool(cfg.get("lattice_residual", False)):
        return mesh
    from ..ops.lattice2d import reorder_mesh_elements, strip_element_order

    try:
        order = strip_element_order(mesh)
    except ValueError:
        return mesh
    if (order == np.arange(len(order))).all():
        return mesh
    print(f"lattice_residual: renumbered {len(order)} strip elements "
          "row-major over the cell lattice")
    # restart checkpoints tag the element ordering they were written
    # under (state arrays and, at order >= 2, dof numbering follow it)
    cfg["_elem_order"] = "strip-row-major"
    return reorder_mesh_elements(mesh, order)
