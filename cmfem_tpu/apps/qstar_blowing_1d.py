"""1D Q* ablation verification with laminar blowing correction.

Mirrors /root/reference/myapps/convection_diffusion/ablation_qstar_blowing_1D.cpp:
steady moving-frame problem k T_xx + rho Cv sdot T_x = 0 with surface
energy balance -k T_x(0) = q_aero(sdot) - rho sdot Q*, laminar blowing
phi = xi/(exp(xi)-1).  Coupled Newton in [T_1..T_{N-1}, sdot] with
Armijo-style backtracking and a sdot>0 guard (:554-578); the reference's
hand-coded analytic Jacobian (:447-509) is replaced by ``jax.jacfwd`` of
the residual; the dense partial-pivot LU (:389-445) by
``jax.scipy.linalg.lu_factor``.  Same CSV outputs (profile + summary).
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass

import numpy as np


@dataclass
class QstarParams:
    num_elements: int = 512
    L: float = 3.0e-2
    k: float = 0.2
    rho: float = 2000.0
    Cv: float = 1000.0
    Qstar: float = 2.0e6
    q_table: float = 2.0e6
    T_abl: float = 800.0
    T_inf: float = 300.0
    lam: float = 0.5
    rhoe_ue_Ch0: float = 2.3692465
    Cp_air: float = 1.00416e3
    T_ref: float = 300.0
    T_recovery: float = 1800.0
    newton_max_iter: int = 30
    newton_abs_tol: float = 1.0e-10
    newton_rel_tol: float = 1.0e-10
    init_s_factor: float = 1.0
    verbose: bool = True
    output_dir: str = "ParaView/qstar_ablation_blowing_1D"
    profile_csv: str = "qstar_blowing_profile.csv"
    summary_csv: str = "qstar_blowing_summary.csv"


def alpha_of(p: QstarParams):
    return p.k / (p.rho * p.Cv)


def table_recession_rate(p: QstarParams):
    return p.q_table / (p.rho * (p.Cv * (p.T_abl - p.T_inf) + p.Qstar))


def exact_temperature(p: QstarParams, x, sdot):
    return p.T_inf + (p.T_abl - p.T_inf) * np.exp(-sdot * np.asarray(x) / alpha_of(p))


def surface_d1_weights(N: int, dx: float):
    """One-sided forward-difference weights for T_x(0): 4th/3rd/2nd order
    by available stencil width (reference :343-369)."""
    if N >= 4:
        return np.array([-25.0, 48.0, -36.0, 16.0, -3.0]) / (12.0 * dx)
    if N >= 3:
        return np.array([-11.0, 18.0, -9.0, 2.0]) / (6.0 * dx)
    return np.array([-3.0, 4.0, -1.0]) / (2.0 * dx)


def run(p: QstarParams) -> dict:
    import jax
    import jax.numpy as jnp

    if p.num_elements < 2:
        raise ValueError("num_elements must be >= 2.")
    if p.T_abl <= p.T_inf:
        raise ValueError("Expected T_abl > T_inf for this verification case.")
    if p.rhoe_ue_Ch0 <= 0:
        raise ValueError("rhoe_ue_Ch0 must be > 0.")
    if p.init_s_factor <= 0:
        raise ValueError("init_s_factor must be > 0.")

    N = p.num_elements
    nT = N - 1
    dx = p.L / N
    d1w = jnp.asarray(surface_d1_weights(N, dx))
    hr = p.Cp_air * (p.T_recovery - p.T_ref)
    hw = p.Cp_air * (p.T_abl - p.T_ref)
    dh = hr - hw

    def blowing_phi(sdot):
        m_dot = p.rho * jnp.maximum(sdot, 0.0)
        xi = 2.0 * p.lam * m_dot / p.rhoe_ue_Ch0
        small = jnp.abs(xi) < 1.0e-8
        xi_safe = jnp.where(small, 1.0, xi)
        series = 1.0 - 0.5 * xi + xi**2 / 12.0 - xi**4 / 720.0
        full = xi_safe / jnp.expm1(xi_safe)
        return jnp.where(small, series, full), xi

    def residual(u):
        T_int = u[:nT]
        sdot = u[nT]
        T = jnp.concatenate([jnp.array([p.T_abl]), T_int, jnp.array([p.T_inf])])
        adv = p.rho * p.Cv * sdot
        R_int = (p.k * (T[2:] - 2.0 * T[1:-1] + T[:-2]) / dx**2
                 + adv * (T[2:] - T[:-2]) / (2.0 * dx))
        dTdx0 = jnp.dot(d1w, T[: len(d1w)])
        phi, _ = blowing_phi(sdot)
        q_aero = p.rhoe_ue_Ch0 * phi * dh
        R_s = -p.k * dTdx0 - q_aero + p.rho * sdot * p.Qstar
        return jnp.concatenate([R_int, jnp.array([R_s])])

    jac = jax.jit(jax.jacfwd(residual))
    res_jit = jax.jit(residual)

    # initial guess: blend of linear and exponential profiles (:523-531)
    s_table = table_recession_rate(p)
    s0 = p.init_s_factor * s_table
    xs = np.arange(1, nT + 1) * dx
    t_lin = p.T_abl + (p.T_inf - p.T_abl) * (xs / p.L)
    t_ex = exact_temperature(p, xs, s0)
    u = jnp.asarray(np.concatenate([0.5 * (t_lin + t_ex), [s0]]))

    R = res_jit(u)
    r0 = max(float(jnp.max(jnp.abs(R))), 1.0)
    if p.verbose:
        print("Newton iterations (full coupled solve):")
        print(f"  iter 0: |R|inf={float(jnp.max(jnp.abs(R))):.6e}, sdot={float(u[nT]):.6e}")

    converged = False
    iters = 0
    residual_inf = float("inf")
    update_rel_inf = float("inf")
    for it in range(1, p.newton_max_iter + 1):
        J = jac(u)
        du = jnp.linalg.solve(J, -R)
        Rn = float(jnp.max(jnp.abs(R)))
        alpha = 1.0
        for _ in range(20):
            u_trial = u + alpha * du
            if float(u_trial[nT]) <= 0.0:
                alpha *= 0.5
                continue
            R_trial = res_jit(u_trial)
            tn = float(jnp.max(jnp.abs(R_trial)))
            if tn <= (1.0 - 1.0e-4 * alpha) * Rn or tn < Rn:
                break
            alpha *= 0.5
        scale = jnp.maximum(1.0, jnp.abs(u))
        update_rel_inf = float(jnp.max(jnp.abs(alpha * du) / scale))
        u = u_trial
        R = R_trial
        residual_inf = float(jnp.max(jnp.abs(R)))
        iters = it
        if p.verbose:
            print(f"  iter {it}: |R|inf={residual_inf:.6e}, "
                  f"rel_update={update_rel_inf:.6e}, alpha={alpha:g}, "
                  f"sdot={float(u[nT]):.6e}")
        if (residual_inf <= p.newton_abs_tol
                or update_rel_inf <= p.newton_rel_tol
                or residual_inf <= p.newton_abs_tol * r0):
            converged = True
            break

    if not converged:
        raise RuntimeError("Newton did not converge within max iterations.")

    s_num = float(u[nT])
    T_full = np.concatenate([[p.T_abl], np.asarray(u[:nT]), [p.T_inf]])
    xs_full = np.arange(N + 1) * dx

    def profile_errors(s_ref):
        err = T_full - exact_temperature(p, xs_full, s_ref)
        linf = np.abs(err).max()
        trap = np.sqrt(np.sum(0.5 * dx * (err[:-1] ** 2 + err[1:] ** 2)))
        rms = np.sqrt(np.mean(err**2))
        return linf, trap, rms

    e_table = profile_errors(s_table)
    e_num = profile_errors(s_num)
    s_rel_err = (s_num - s_table) / s_table

    dTdx0_num = float(np.dot(np.asarray(d1w), T_full[: len(np.asarray(d1w))]))

    print("\nConverged solution")
    print(f"  Newton iterations             = {iters}")
    print(f"  Final |R|inf                  = {residual_inf:.6e}")
    print(f"  Numerical sdot [m/s]          = {s_num:.8e}")
    print(f"  Table-4 analytical sdot [m/s] = {s_table:.8e}")
    print(f"  Relative sdot error vs Table4 = {s_rel_err:.6e}")
    print(f"  Profile error vs Table4 exact: Linf[K]={e_table[0]:.6e}, "
          f"L2_trap={e_table[1]:.6e}, RMS_nodes[K]={e_table[2]:.6e}")
    print(f"  Profile error vs exact(s_num): Linf[K]={e_num[0]:.6e}, "
          f"L2_trap={e_num[1]:.6e}, RMS_nodes[K]={e_num[2]:.6e}")

    os.makedirs(p.output_dir, exist_ok=True)
    prof_path = os.path.join(p.output_dir, p.profile_csv)
    with open(prof_path, "w") as f:
        f.write("x_m,T_numeric_K,T_exact_table_K,T_exact_numerical_s_K,abs_err_table_K\n")
        Tt = exact_temperature(p, xs_full, s_table)
        Tn = exact_temperature(p, xs_full, s_num)
        for i in range(N + 1):
            f.write(f"{xs_full[i]:.16e},{T_full[i]:.16e},{Tt[i]:.16e},"
                    f"{Tn[i]:.16e},{abs(T_full[i]-Tt[i]):.16e}\n")
    sum_path = os.path.join(p.output_dir, p.summary_csv)
    header = not os.path.exists(sum_path) or os.path.getsize(sum_path) == 0
    with open(sum_path, "a") as f:
        if header:
            f.write("num_elements,L_m,k_W_mK,rho_kg_m3,Cv_J_kgK,Qstar_J_kg,"
                    "q_table_W_m2,lambda,rhoe_ue_Ch0,sdot_table_m_s,"
                    "sdot_numerical_m_s,sdot_rel_error\n")
        f.write(f"{N},{p.L:.16e},{p.k:.16e},{p.rho:.16e},{p.Cv:.16e},"
                f"{p.Qstar:.16e},{p.q_table:.16e},{p.lam:.16e},"
                f"{p.rhoe_ue_Ch0:.16e},{s_table:.16e},{s_num:.16e},"
                f"{s_rel_err:.16e}\n")

    return {
        "converged": converged, "iterations": iters, "sdot": s_num,
        "sdot_table": s_table, "sdot_rel_error": s_rel_err,
        "err_vs_table": e_table, "err_vs_snum": e_num,
        "T": T_full, "x": xs_full, "dTdx0": dTdx0_num,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-elements", type=int, default=512)
    ap.add_argument("--max-iter", type=int, default=30)
    ap.add_argument("--abs-tol", type=float, default=1.0e-10)
    ap.add_argument("--rel-tol", type=float, default=1.0e-10)
    ap.add_argument("--init-s-factor", type=float, default=1.0)
    ap.add_argument("--lambda", dest="lam", type=float, default=0.5)
    ap.add_argument("--rhoe-ue-ch0", type=float, default=2.3692465)
    ap.add_argument("--output-dir", default="ParaView/qstar_ablation_blowing_1D")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    p = QstarParams(
        num_elements=args.num_elements, newton_max_iter=args.max_iter,
        newton_abs_tol=args.abs_tol, newton_rel_tol=args.rel_tol,
        init_s_factor=args.init_s_factor, lam=args.lam,
        rhoe_ue_Ch0=args.rhoe_ue_ch0, output_dir=args.output_dir,
        verbose=not args.quiet,
    )
    run(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
