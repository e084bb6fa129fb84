"""Ablation test case 1: coupled (T, p) pyrolysis with Dirichlet wall T.

Mirrors /root/reference/myapps/convection_diffusion/ablation_test_case1_2D.cpp:
TACOT strip heated by a tabulated wall-temperature schedule at constant top
pressure; per-QP reaction state; per-step block Newton solve; probes /
mass-metrics / newton / timing CSVs and ParaView fields including
per-reaction extents.  The MUMPS direct solves (Input/petsc_ablation.opts)
are replaced by a host sparse LU over AD-assembled element Jacobians (the
systems are a few thousand DOFs); the residual and Jacobian evaluations run
jitted and batched.
"""

from __future__ import annotations

import os
import sys
import time as _time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from .common import (
    check_linear_result, linear_usable, load_newton_config, scan_newton,
    replay_newton_history,
    parse_args, load_mesh_from_cfg, echo_config,
    ensure_outdir, num_steps, make_block_linear_solver,
    run_tp_newton_loop, maybe_enable_lattice_residual,
    NewtonStallStats,
    maybe_reorder_strip_mesh,
)
from ..utils.compile_cache import enable_compile_cache
from ..utils.yamlcfg import load_yaml, resolve_path
from ..io import CsvWriter, VTUCollection


def evaluate_schedule(schedule, t):
    """Piecewise-linear (time, value) schedule (EvaluateSchedule :111-145)."""
    ts = np.asarray([s[0] for s in schedule])
    vs = np.asarray([s[1] for s in schedule])
    return float(np.interp(t, ts, vs))


DEFAULT_SCHEDULE = [
    [0.0, 300.0], [0.1, 1644.0], [60.0, 1644.0], [60.1, 300.0], [120.0, 300.0],
]


def _make_case1_csvs(cfg, output_path, probe_y):
    """The driver's four CSV streams (shared by the eager and scan paths)."""
    probes_csv = CsvWriter(
        os.path.join(output_path,
                     cfg.get("probes_csv", "temperature_probes.csv")),
        ["time", "wall"] + [f"TC{i}" for i in range(1, len(probe_y))])
    mass_csv = CsvWriter(
        os.path.join(output_path, cfg.get("mass_csv", "mass_metrics.csv")),
        ["time", "m_dot_g_surf", "m_dot_c", "front_98_virgin",
         "front_2_char", "recession"])
    newton_csv = CsvWriter(
        os.path.join(output_path,
                     cfg.get("newton_csv",
                             "newton_history_ablation_case1_2D.csv")),
        ["step", "time", "iter", "residual", "residual0", "rel_residual",
         "update_norm", "update0", "rel_update", "converged"])
    timing_csv = CsvWriter(
        os.path.join(output_path,
                     cfg.get("timing_step_csv",
                             "driver_timing_per_step.csv")),
        ["step", "bc_sec", "newton_sec", "newton_residual_eval_sec",
         "newton_jacobian_sec", "newton_linear_sec", "newton_update_sec",
         "state_advance_sec", "output_sec", "step_total_sec"])
    return probes_csv, mass_csv, newton_csv, timing_csv


def _write_tolerances_csv(cfg, output_path):
    """Acceptance tolerance echo (fiat_error_tolerances.csv)."""
    acc = cfg.get("acceptance", {})
    with CsvWriter(os.path.join(output_path, "fiat_error_tolerances.csv"),
                   ["signal", "tolerance"]) as w:
        w.writerow(["temperature_rmse_max",
                    float(acc.get("temperature_rmse_max", 150.0))])
        w.writerow(["temperature_max_abs_max",
                    float(acc.get("temperature_max_abs_max", 300.0))])
        w.writerow(["m_dot_g_peak_rel_error_max",
                    float(acc.get("m_dot_g_peak_rel_error_max", 0.5))])
        w.writerow(["m_dot_g_peak_time_error_max",
                    float(acc.get("m_dot_g_peak_time_error_max", 10.0))])
        w.writerow(["front98_rmse_max",
                    float(acc.get("front98_rmse_max", 0.01))])
        w.writerow(["front2_rmse_max",
                    float(acc.get("front2_rmse_max", 0.01))])


def run(cfg: dict) -> dict:
    if cfg.get("scan_stepping", False):
        if int(cfg.get("sharding_devices", 0)) or \
                int(cfg.get("dof_partition", 0)):
            raise ValueError("scan_stepping is mutually exclusive with "
                             "sharding_devices / dof_partition")
        return run_scan(cfg)
    import jax
    import jax.numpy as jnp

    from ..core import FESpace
    from ..ops import SpaceOps
    from ..core.pointlocate import sample_h1, front_depth
    from ..physics.tacot import TacotMaterial
    from ..physics.ablation import AblationSystem, AblationState
    from ..utils.timing import StepTimer

    material_file = resolve_path(cfg, cfg.get("material_file",
                                              "Input/material_tacot_case1.yaml"))
    order = int(cfg.get("order", 1))
    dt_cfg = float(cfg.get("dt", 1.0e-2))
    t_final = float(cfg.get("t_final", 120.0))
    newton_cfg = load_newton_config(cfg)
    newton_print_level = int(cfg.get("newton_print_level", 1))
    jacobian_rebuild_freq = max(1, int(cfg.get("newton_jacobian_rebuild_freq", 1)))
    jacobian_check = bool(cfg.get("jacobian_check", False))
    jc_abs = float(cfg.get("jacobian_check_abs_tol", 1e-6))
    jc_rel = float(cfg.get("jacobian_check_rel_tol", 1e-4))
    output_every = int(cfg.get("output_every", 10))
    if output_every < 1:
        raise ValueError("output_every must be >= 1")
    output_path = cfg.get("output_path", "ParaView/ablation_case1")
    collection_name = cfg.get("collection_name", "ablation_test_case1_2D")
    save_paraview = bool(cfg.get("save_paraview", True))
    bdr_top = int(cfg.get("bdr_attr_top", 1))
    top_pressure = float(cfg.get("top_pressure", 101325.0))
    schedule = cfg.get("top_temperature_schedule", DEFAULT_SCHEDULE)
    schedule = sorted([[float(a), float(b)] for a, b in schedule])
    gravity = (float(cfg.get("gravity_x", 0.0)), float(cfg.get("gravity_y", 0.0)))
    probe_x = float(cfg.get("probe_x", 0.005))
    probe_y = [float(v) for v in cfg.get(
        "probe_y", [0.05, 0.049, 0.048, 0.046, 0.042, 0.038, 0.034, 0.026])]
    if dt_cfg <= 0 or t_final < 0 or order < 1:
        raise ValueError("invalid dt/t_final/order")
    if not schedule:
        raise ValueError("top_temperature_schedule cannot be empty.")

    timer = StepTimer()
    mat = TacotMaterial.load_yaml(material_file)
    mesh = maybe_reorder_strip_mesh(cfg, load_mesh_from_cfg(cfg))
    lo, hi = mesh.bounding_box()
    xmid = 0.5 * (lo[0] + hi[0])
    fes = FESpace(mesh, order)
    n = fes.nscalar
    print(f"Global true dofs (T): {n}")
    print(f"Global true dofs (p): {n}")
    print(f"Global true dofs (T+p): {2 * n}")

    quad_order = max(2, 2 * order + 2)
    ops = SpaceOps(fes, quad_order=quad_order)
    sys_ = AblationSystem(ops, mat, gravity=gravity, top_attr=bdr_top)
    maybe_enable_lattice_residual(cfg, sys_, fes)
    ne, nq = sys_.ne, sys_.nq
    state = AblationState.initial(ne, nq, mat)

    ess = np.asarray(fes.boundary_dofs([bdr_top]))
    ess_mask = np.zeros(n, dtype=bool)
    ess_mask[ess] = True
    ess2 = np.concatenate([ess, ess + n])
    mask2 = np.zeros(2 * n, dtype=bool)
    mask2[ess2] = True
    mask2_j = jnp.asarray(mask2)

    # static sparsity structure of the 2x2 block Jacobian
    ed = np.asarray(fes.element_dofs, dtype=np.int64)
    nd = ed.shape[1]
    rows_b = np.repeat(ed, nd, axis=1).reshape(-1)
    cols_b = np.tile(ed, (1, nd)).reshape(-1)
    rows_all = np.concatenate([rows_b, rows_b, rows_b + n, rows_b + n])
    cols_all = np.concatenate([cols_b, cols_b + n, cols_b, cols_b + n])

    T = jnp.full(n, 300.0)
    p = jnp.full(n, top_pressure)
    Tbc0 = evaluate_schedule(schedule, 0.0)
    T = T.at[jnp.asarray(ess)].set(Tbc0)
    p = p.at[jnp.asarray(ess)].set(top_pressure)

    # sharding_devices: N runs the whole Newton step element-sharded over
    # an N-device jax.sharding.Mesh (the `mpirun -np N` replacement);
    # per-step old-state arrays are padded/sharded at step start.
    # dof_partition: N additionally DOF-partitions the (T,p) vectors
    # themselves (owned slabs + ghost halos, the ParFESpace true-dof
    # analog) so device memory scales ~1/N; the host keeps one global
    # copy for BCs and CSV/VTU output, like the reference's rank-0 I/O.
    shard_n = int(cfg.get("sharding_devices", 0))
    dofp_n = int(cfg.get("dof_partition", 0))
    if shard_n and dofp_n:
        raise ValueError(
            "sharding_devices and dof_partition are mutually exclusive")
    sh = None
    dn = None
    shard_state = {}
    if shard_n:
        from ..parallel import ShardedAblationNewton, make_device_mesh

        ndev = shard_n
        sh = ShardedAblationNewton(
            sys_, make_device_mesh(ndev), ess, ess,
            restart=int(cfg.get("gmres_restart", 400)),
            maxiter=int(cfg.get("gmres_maxiter", 10)))
        lin_rtol = float(cfg.get("linear_rtol", 1.0e-10))
        print(f"element sharding over {ndev} devices "
              f"({sh.ne_pad} padded elements)")
    elif dofp_n:
        from ..parallel import DofPartitionedAblationNewton, make_device_mesh

        dn = DofPartitionedAblationNewton(
            sys_, make_device_mesh(dofp_n), ess, ess,
            restart=int(cfg.get("gmres_restart", 400)),
            maxiter=int(cfg.get("gmres_maxiter", 10)))
        lin_rtol = float(cfg.get("linear_rtol", 1.0e-10))
        print(f"dof partitioning over {dofp_n} devices "
              f"(per-device two-field floats {dn.per_device_floats()} "
              f"vs replicated {2 * n})")

    @jax.jit
    def residual_single(T, p, T_old_q, p_old_q, X_old, dt):
        RT, Rp = sys_.residual(T, p, T_old_q, p_old_q, X_old, dt)
        R = jnp.concatenate([RT, Rp])
        return jnp.where(mask2_j, 0.0, R)

    def residual_fn(T, p, T_old_q, p_old_q, X_old, dt):
        if sh is not None:
            return sh.residual(T, p, shard_state["To"], shard_state["po"],
                               shard_state["Xo"], dt)
        if dn is not None:
            R_d = dn.residual(dn.to_dist2(np.asarray(T), np.asarray(p)),
                              shard_state["To"], shard_state["po"],
                              shard_state["Xo"], dt)
            RT, Rp = dn.from_dist2(R_d)
            return jnp.asarray(np.concatenate([RT, Rp]))
        return residual_single(T, p, T_old_q, p_old_q, X_old, dt)

    @jax.jit
    def jacobian_blocks(T, p, T_old_q, p_old_q, X_old, dt):
        return sys_.element_jacobians(T, p, T_old_q, p_old_q, X_old, dt)

    iter_factory = make_block_linear_solver(cfg, fes.element_dofs, n, ess, ess,
                                            node_positions=fes.node_positions)

    class _ShardedPrepared:
        def __init__(self, factors):
            self.factors = factors

        def solve(self, rhs):
            res = sh.solve(self.factors, jnp.asarray(rhs), rtol=lin_rtol)
            check_linear_result(res, "block GMRES")
            return np.asarray(res.x)

    class _DofPartPrepared:
        def __init__(self, factors):
            self.factors = factors

        def solve(self, rhs):
            rhs = np.asarray(rhs)
            res = dn.solve(self.factors, dn.to_dist2(rhs[:n], rhs[n:]),
                           rtol=lin_rtol)
            check_linear_result(res, "distributed block GMRES")
            dxT, dxp = dn.from_dist2(res.x)
            return np.concatenate([dxT, dxp])

    def factorize(T, p, T_old_q, p_old_q, X_old, dt):
        if sh is not None:
            return _ShardedPrepared(sh.prepare(
                T, p, shard_state["To"], shard_state["po"],
                shard_state["Xo"], dt))
        if dn is not None:
            return _DofPartPrepared(dn.prepare(
                dn.to_dist2(np.asarray(T), np.asarray(p)),
                shard_state["To"], shard_state["po"],
                shard_state["Xo"], dt))
        blocks = jacobian_blocks(T, p, T_old_q, p_old_q, X_old, dt)
        if iter_factory is not None:
            return iter_factory(blocks)
        JTT, JTp, JpT, Jpp = blocks
        vals = np.concatenate([np.asarray(b).reshape(-1)
                               for b in (JTT, JTp, JpT, Jpp)])
        J = sp.coo_matrix((vals, (rows_all, cols_all)),
                          shape=(2 * n, 2 * n)).tocsr()
        # essential elimination: identity rows/cols
        keep = ~mask2
        d = sp.diags(keep.astype(np.float64))
        J = d @ J @ d + sp.diags(mask2.astype(np.float64))
        return spla.splu(J.tocsc())

    ensure_outdir(output_path)
    probes_csv, mass_csv, newton_csv, timing_csv = _make_case1_csvs(
        cfg, output_path, probe_y)

    l2like = lambda vals: np.asarray(vals)
    dc = None
    if save_paraview:
        dc = VTUCollection(collection_name, fes, prefix_path=output_path)

    nr = mat.num_reactions
    probe_pts = np.array([[probe_x, y] for y in probe_y[1:]])

    def write_outputs(step, t):
        wallT = evaluate_schedule(schedule, t)
        probe_vals = sample_h1(fes, np.asarray(T), probe_pts)
        mdot_surf = float(sys_.top_boundary_mass_flux(T, p, state))
        f98 = front_depth(mesh, state.tau_elem, xmid, hi[1], lo[1], 0.98)
        f2 = front_depth(mesh, state.tau_elem, xmid, hi[1], lo[1], 0.02)
        probes_csv.writerow([t, wallT] + [float(v) for v in probe_vals])
        mass_csv.writerow([t, mdot_surf, 0.0, f98, f2, 0.0])
        if dc is not None and step % output_every == 0:
            fields = {
                "temperature": np.asarray(T),
                "pressure": np.asarray(p),
                "tau": l2like(state.tau_elem),
                "rho_s": l2like(state.rho_elem),
                "pi_total": l2like(state.pi_elem),
                "m_dot_g": l2like(state.mdot_elem),
                "degree_char": l2like(state.degree_char_elem),
                "char_density_fraction": l2like(state.char_density_fraction_elem),
            }
            for r in range(nr):
                fields[f"X{r + 1}"] = l2like(state.extent_elem[r])
            dc.save(step, t, fields)
        return mdot_surf, f98, f2

    write_outputs(0, 0.0)
    nsteps = num_steps(t_final, dt_cfg)
    print(f"Time steps: {nsteps}, nominal final time: {nsteps * dt_cfg}")

    t = 0.0
    totals = {k: 0.0 for k in ("bc", "newton", "nres", "njac", "nlin", "nupd",
                               "state", "output", "step")}
    for step in range(1, nsteps + 1):
        step_t0 = _time.perf_counter()
        t_next = min(t_final, t + dt_cfg)
        dt_step = t_next - t
        t = t_next

        T_old_q = ops.values_at_qp(T)
        p_old_q = ops.values_at_qp(p)
        X_old = state.extent
        if sh is not None:
            shard_state["To"] = sh.pad_elem(T_old_q)
            shard_state["po"] = sh.pad_elem(p_old_q)
            shard_state["Xo"] = sh.pad_elem(X_old)
        elif dn is not None:
            shard_state["To"] = dn.pack_elem(np.asarray(T_old_q))
            shard_state["po"] = dn.pack_elem(np.asarray(p_old_q))
            shard_state["Xo"] = dn.pack_elem(np.asarray(X_old))

        bc_t0 = _time.perf_counter()
        Tbc = evaluate_schedule(schedule, t)
        T = T.at[jnp.asarray(ess)].set(Tbc)
        p = p.at[jnp.asarray(ess)].set(top_pressure)
        bc_sec = _time.perf_counter() - bc_t0

        if jacobian_check and step == 1:
            rel = sys_.jacobian_check(T, p, T_old_q, p_old_q, X_old,
                                      dt_step, abs_tol=jc_abs, rel_tol=jc_rel)
            print(f"jacobian_check passed (max rel err {rel:.3e})")

        # shared Newton loop (Jacobian refactorized every
        # jacobian_rebuild_freq iterations, newton_petsc_solver.hpp:224)
        newton_t0 = _time.perf_counter()

        def _enforce_bc(T, p):
            return (T.at[jnp.asarray(ess)].set(Tbc),
                    p.at[jnp.asarray(ess)].set(top_pressure))

        T, p, iters, ntim = run_tp_newton_loop(
            T, p,
            residual=lambda T, p: residual_fn(T, p, T_old_q, p_old_q,
                                              X_old, dt_step),
            factorize=lambda T, p: factorize(T, p, T_old_q, p_old_q,
                                             X_old, dt_step),
            enforce_bc=_enforce_bc, newton_cfg=newton_cfg,
            rebuild_freq=jacobian_rebuild_freq, newton_csv=newton_csv,
            step=step, t=t, n=n, print_level=newton_print_level)
        nres, njac, nlin, nupd = (ntim["nres"], ntim["njac"], ntim["nlin"],
                                  ntim["nupd"])
        newton_sec = _time.perf_counter() - newton_t0

        st_t0 = _time.perf_counter()
        state = sys_.advance_state(state, T, p, dt_step)
        state_sec = _time.perf_counter() - st_t0

        out_t0 = _time.perf_counter()
        write_outputs(step, t)
        out_sec = _time.perf_counter() - out_t0
        step_sec = _time.perf_counter() - step_t0
        timing_csv.writerow([step, bc_sec, newton_sec, nres, njac, nlin,
                             nupd, state_sec, out_sec, step_sec])
        for k, v in zip(("bc", "newton", "nres", "njac", "nlin", "nupd",
                         "state", "output", "step"),
                        (bc_sec, newton_sec, nres, njac, nlin, nupd,
                         state_sec, out_sec, step_sec)):
            totals[k] += v
        if step <= 5 or step % 50 == 0 or step == nsteps:
            print(f"step={step} t={t:g} newton_iters={iters} "
                  f"Tmax={float(jnp.max(T)):.1f} "
                  f"tau_min={state.tau_elem.min():.4f}")

    _write_tolerances_csv(cfg, output_path)

    with CsvWriter(os.path.join(output_path,
                                cfg.get("timing_summary_csv",
                                        "driver_timing_summary.csv")),
                   ["metric", "seconds"]) as w:
        summ = timer.summary()
        w.writerow(["setup_time_maxrank", summ.get("wall", 0.0) - totals["step"]])
        w.writerow(["run_time_maxrank", summ.get("wall", 0.0)])
        w.writerow(["sum_step_time_maxrank", totals["step"]])
        w.writerow(["sum_bc_time_maxrank", totals["bc"]])
        w.writerow(["sum_newton_time_maxrank", totals["newton"]])
        w.writerow(["sum_newton_residual_eval_time_maxrank", totals["nres"]])
        w.writerow(["sum_newton_jacobian_time_maxrank", totals["njac"]])
        w.writerow(["sum_newton_linear_time_maxrank", totals["nlin"]])
        w.writerow(["sum_newton_update_time_maxrank", totals["nupd"]])
        w.writerow(["sum_state_advance_time_maxrank", totals["state"]])
        w.writerow(["sum_output_time_maxrank", totals["output"]])
        w.writerow(["avg_step_time_maxrank",
                    totals["step"] / max(1, nsteps)])

    probes_csv.close()
    mass_csv.close()
    newton_csv.close()
    timing_csv.close()
    return {"T": np.asarray(T), "p": np.asarray(p), "state": state,
            "fes": fes, "mesh": mesh}


def run_scan(cfg: dict) -> dict:
    """Whole-run on-device stepping (``scan_stepping: true``): the
    transient solve — BC schedule, per-step Newton (``lax.while_loop``
    with the on-device equilibrated block-GMRES of solvers/blocksolve),
    reaction-state advance, probe/mass diagnostics — compiles to
    ``lax.scan`` programs of ``output_every`` steps each, so host-device
    round trips happen once per OUTPUT FRAME instead of once per Newton
    iteration.  Same CSV schemas and ParaView cadence as the eager path;
    per-step *phase* timings are not observable inside the fused program,
    so the timing CSV carries the amortized step total only."""
    import jax
    import jax.numpy as jnp

    from ..core import FESpace
    from ..ops import SpaceOps
    from ..core.pointlocate import (front_depth, front_depth_static,
                                    front_line_stencil,
                                    h1_sampling_stencil)
    from ..physics.tacot import TacotMaterial
    from ..physics.ablation import AblationSystem, AblationState


    material_file = resolve_path(cfg, cfg.get("material_file",
                                              "Input/material_tacot_case1.yaml"))
    order = int(cfg.get("order", 1))
    dt_cfg = float(cfg.get("dt", 1.0e-2))
    t_final = float(cfg.get("t_final", 120.0))
    abs_tol = float(cfg.get("newton_abs_tol", 1e-8))
    rel_tol = float(cfg.get("newton_rel_tol", 1e-6))
    max_iter = int(cfg.get("newton_max_iter", 20))
    stall_kw = dict(
        stall_improve=float(cfg.get("newton_stall_improve", 1e-3)),
        stall_patience=int(cfg.get("newton_stall_patience", 2)),
        stall_accept_rel=float(cfg.get("newton_stall_accept_rel", 1e-3)),
        stall_dx_rtol=cfg.get("newton_stall_dx_rtol", None),
        stall_flat_factor=float(cfg.get("newton_stall_flat_factor", 1.15)))
    lin_rtol = float(cfg.get("linear_rtol", 1.0e-10))
    output_every = int(cfg.get("output_every", 10))
    if output_every < 1:
        raise ValueError("output_every must be >= 1")
    output_path = cfg.get("output_path", "ParaView/ablation_case1")
    collection_name = cfg.get("collection_name", "ablation_test_case1_2D")
    save_paraview = bool(cfg.get("save_paraview", True))
    bdr_top = int(cfg.get("bdr_attr_top", 1))
    top_pressure = float(cfg.get("top_pressure", 101325.0))
    schedule = cfg.get("top_temperature_schedule", DEFAULT_SCHEDULE)
    schedule = sorted([[float(a), float(b)] for a, b in schedule])
    gravity = (float(cfg.get("gravity_x", 0.0)), float(cfg.get("gravity_y", 0.0)))
    probe_x = float(cfg.get("probe_x", 0.005))
    probe_y = [float(v) for v in cfg.get(
        "probe_y", [0.05, 0.049, 0.048, 0.046, 0.042, 0.038, 0.034, 0.026])]
    if dt_cfg <= 0 or t_final < 0 or order < 1:
        raise ValueError("invalid dt/t_final/order")
    if not schedule:
        raise ValueError("top_temperature_schedule cannot be empty.")
    if output_every < 1:
        raise ValueError("output_every must be >= 1")

    mat = TacotMaterial.load_yaml(material_file)
    mesh = maybe_reorder_strip_mesh(cfg, load_mesh_from_cfg(cfg))
    lo, hi = mesh.bounding_box()
    xmid = 0.5 * (lo[0] + hi[0])
    fes = FESpace(mesh, order)
    n = fes.nscalar
    print(f"Global true dofs (T): {n}\nGlobal true dofs (p): {n}\n"
          f"Global true dofs (T+p): {2 * n}")
    ops = SpaceOps(fes, quad_order=max(2, 2 * order + 2))
    sys_ = AblationSystem(ops, mat, gravity=gravity, top_attr=bdr_top)
    maybe_enable_lattice_residual(cfg, sys_, fes)
    state0 = AblationState.initial(sys_.ne, sys_.nq, mat)

    ess = np.asarray(fes.boundary_dofs([bdr_top]))
    essj = jnp.asarray(ess)
    mask2 = np.zeros(2 * n, dtype=bool)
    mask2[ess] = True
    mask2[ess + n] = True
    mask2_j = jnp.asarray(mask2)
    from ..solvers.blocksolve import make_scan_block_solver
    bks = make_scan_block_solver(cfg, fes.element_dofs, n, ess, ess,
                                 fes.node_positions)

    sched_t = jnp.asarray([s[0] for s in schedule])
    sched_v = jnp.asarray([s[1] for s in schedule])
    probe_pts = np.array([[probe_x, y] for y in probe_y[1:]])
    pdofs, pweights = h1_sampling_stencil(fes, probe_pts)
    pdofs_j = jnp.asarray(pdofs)
    pw_j = jnp.asarray(pweights)

    nsteps = num_steps(t_final, dt_cfg)
    t_edges = np.minimum(t_final, dt_cfg * np.arange(nsteps + 1))
    print(f"Time steps: {nsteps}, nominal final time: {t_edges[-1]}")

    def residual_fn(T, p, T_old_q, p_old_q, X_old, dt):
        RT, Rp = sys_.residual(T, p, T_old_q, p_old_q, X_old, dt)
        return jnp.where(mask2_j, 0.0, jnp.concatenate([RT, Rp]))

    def step_fn(carry, inp):
        T, p, X, rho_e, pi_e, mdot_e, extent_e, pi_qp = carry
        t, dt = inp
        T_old_q = ops.values_at_qp(T)
        p_old_q = ops.values_at_qp(p)
        Tbc = jnp.interp(t, sched_t, sched_v)
        T = T.at[essj].set(Tbc)
        p = p.at[essj].set(top_pressure)

        def solve(T, p, R):
            blocks = sys_.element_jacobians(T, p, T_old_q, p_old_q, X, dt)
            fac = bks._prepare(*blocks)
            sol = bks._solve(*fac, -R, jnp.asarray(lin_rtol),
                             jnp.asarray(0.0))
            dx = sol.x
            Tn = (T + dx[:n]).at[essj].set(Tbc)
            pn = (p + dx[n:]).at[essj].set(top_pressure)
            return Tn, pn, jnp.linalg.norm(dx), linear_usable(sol)

        (T, p, it, r0, rn, done, res_h, upd_h, lin_ok,
            nw_stalled) = scan_newton(
            T, p,
            residual=lambda T, p: residual_fn(T, p, T_old_q, p_old_q, X,
                                              dt),
            solve=solve, abs_tol=abs_tol, rel_tol=rel_tol,
            max_iter=max_iter, **stall_kw)

        (X, tau_e, rho_e, pi_e, mdot_e, extent_e,
         pi_qp) = sys_.advance_state_arrays(X, T, p, dt)
        probe_vals = jnp.einsum("pn,pn->p", pw_j, T[pdofs_j])
        mdot_surf = sys_.top_boundary_mass_flux(T, p, X)
        carry = (T, p, X, rho_e, pi_e, mdot_e, extent_e, pi_qp)
        out = (probe_vals, mdot_surf, tau_e, it, r0, rn, done,
               res_h, upd_h, Tbc, lin_ok, nw_stalled)
        return carry, out

    @jax.jit
    def simulate_chunk(carry, ts, dts):
        return jax.lax.scan(step_fn, carry, (ts, dts))

    # ---- outputs ----
    ensure_outdir(output_path)
    probes_csv, mass_csv, newton_csv, timing_csv = _make_case1_csvs(
        cfg, output_path, probe_y)
    dc = VTUCollection(collection_name, fes, prefix_path=output_path) \
        if save_paraview else None
    nr = mat.num_reactions
    rho_v = mat.initial_solid_density()
    rho_c = mat.char_solid_density()
    den = rho_v - rho_c

    def build_state(X, tau_e, rho_e, pi_e, mdot_e, extent_e, pi_qp):
        tau_e = np.asarray(tau_e)
        rho_e = np.asarray(rho_e)
        cdf = np.clip((rho_v - rho_e) / den, 0.0, 1.0) \
            if abs(den) > 1e-14 else np.zeros_like(rho_e)
        return AblationState(
            extent=X, tau_elem=tau_e, rho_elem=rho_e,
            pi_elem=np.asarray(pi_e), mdot_elem=np.asarray(mdot_e),
            extent_elem=np.asarray(extent_e),
            degree_char_elem=np.clip(1.0 - tau_e, 0.0, 1.0),
            char_density_fraction_elem=cdf, pi_qp=np.asarray(pi_qp))

    def save_frame(step, t, T, p, st: AblationState):
        fields = {
            "temperature": np.asarray(T), "pressure": np.asarray(p),
            "tau": st.tau_elem, "rho_s": st.rho_elem,
            "pi_total": st.pi_elem, "m_dot_g": st.mdot_elem,
            "degree_char": st.degree_char_elem,
            "char_density_fraction": st.char_density_fraction_elem,
        }
        for r in range(nr):
            fields[f"X{r + 1}"] = st.extent_elem[r]
        dc.save(step, t, fields)

    T0 = jnp.full(n, 300.0)
    p0 = jnp.full(n, top_pressure)
    Tbc0 = evaluate_schedule(schedule, 0.0)
    T0 = T0.at[essj].set(Tbc0)
    carry = (T0, p0, jnp.asarray(state0.extent),
             jnp.asarray(state0.rho_elem), jnp.asarray(state0.pi_elem),
             jnp.asarray(state0.mdot_elem), jnp.asarray(state0.extent_elem),
             jnp.asarray(state0.pi_qp))

    # t = 0 row (initial state) + frame 0
    p0v = np.einsum("pn,pn->p", pweights, np.asarray(T0)[pdofs])
    m0 = float(sys_.top_boundary_mass_flux(T0, p0, state0))
    # static mesh: locate the front sampling line ONCE (the per-step
    # location sweep dominated the post-chunk host loop)
    fl_ids, fl_ys = front_line_stencil(mesh, xmid, hi[1], lo[1])
    f98_0 = front_depth_static(fl_ids, fl_ys, state0.tau_elem, hi[1], 0.98)
    f2_0 = front_depth_static(fl_ids, fl_ys, state0.tau_elem, hi[1], 0.02)
    probes_csv.writerow([0.0, Tbc0] + [float(v) for v in p0v])
    mass_csv.writerow([0.0, m0, 0.0, f98_0, f2_0, 0.0])
    if dc is not None:
        save_frame(0, 0.0, T0, p0, state0)

    wall = 0.0
    bounds = list(range(0, nsteps, output_every)) + [nsteps]
    bounds = sorted(set(bounds))
    stall_stats = NewtonStallStats()
    for b, e in zip(bounds[:-1], bounds[1:]):
        ts = jnp.asarray(t_edges[b + 1:e + 1])
        dts = jnp.asarray(np.diff(t_edges[b:e + 1]))
        w0 = _time.perf_counter()
        carry, outs = simulate_chunk(carry, ts, dts)
        jax.block_until_ready(carry[0])
        wall += _time.perf_counter() - w0
        print(f"[scan] steps {e}/{nsteps} wall={wall:.1f}s "
              f"({1e3 * wall / max(1, e):.0f} ms/step avg)", flush=True)
        (probes, mdots, taus, iters, r0s, rns, dones, res_hs, upd_hs,
         Tbcs, lin_oks, nw_stalls) = [np.asarray(o) for o in outs]
        stall_stats.update(nw_stalls, rns, r0s)
        if nw_stalls.any():
            print(f"WARNING: {int(nw_stalls.sum())}/{e - b} steps "
                  "accepted at the Newton working-precision stall floor "
                  "(not the abs/rel tolerance)", flush=True)
        if not lin_oks.all():
            bad = b + int(np.nonzero(~lin_oks)[0][0]) + 1
            raise RuntimeError(
                f"block GMRES did not converge at step {bad} "
                f"(raise gmres_restart/gmres_maxiter)")
        if not dones.all():
            bad = b + int(np.nonzero(~dones)[0][0]) + 1
            raise RuntimeError(
                f"Newton did not converge at step {bad}, final residual="
                f"{rns[int(np.nonzero(~dones)[0][0])]}")
        amort = wall / e
        for k in range(e - b):
            gstep = b + k + 1
            tk = float(t_edges[gstep])
            probes_csv.writerow([tk, float(Tbcs[k])]
                                + [float(v) for v in probes[k]])
            f98 = front_depth_static(fl_ids, fl_ys, taus[k], hi[1],
                                     0.98)
            f2 = front_depth_static(fl_ids, fl_ys, taus[k], hi[1], 0.02)
            mass_csv.writerow([tk, float(mdots[k]), 0.0, f98, f2, 0.0])
            replay_newton_history(newton_csv, gstep, tk, int(iters[k]),
                                  float(r0s[k]), res_hs[k], upd_hs[k])
            timing_csv.writerow([gstep, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                                 0.0, 0.0, amort])
        if dc is not None and e % output_every == 0:
            st = build_state(carry[2], taus[-1], *carry[3:])
            save_frame(e, float(t_edges[e]), carry[0], carry[1], st)

    (T, p, X, rho_e, pi_e, mdot_e, extent_e, pi_qp) = carry
    taus_f = np.asarray(taus[-1]) if nsteps else state0.tau_elem
    state = build_state(X, taus_f, rho_e, pi_e, mdot_e, extent_e, pi_qp)

    _write_tolerances_csv(cfg, output_path)
    amort = wall / max(1, nsteps)
    with CsvWriter(os.path.join(output_path,
                                cfg.get("timing_summary_csv",
                                        "driver_timing_summary.csv")),
                   ["metric", "seconds"]) as w:
        w.writerow(["setup_time_maxrank", 0.0])
        w.writerow(["run_time_maxrank", wall])
        w.writerow(["sum_step_time_maxrank", wall])
        for k in ("bc", "newton", "newton_residual_eval",
                  "newton_jacobian", "newton_linear", "newton_update",
                  "state_advance", "output"):
            w.writerow([f"sum_{k}_time_maxrank", 0.0])
        w.writerow(["avg_step_time_maxrank", amort])

    probes_csv.close()
    mass_csv.close()
    newton_csv.close()
    timing_csv.close()
    print(f"scan_stepping: {nsteps} steps in {wall:.2f}s "
          f"({amort * 1e3:.1f} ms/step; one fused XLA program per "
          f"{output_every}-step output frame)")
    return {"T": np.asarray(T), "p": np.asarray(p), "state": state,
            "fes": fes, "mesh": mesh,
            "newton_stall_stats": stall_stats.summary()}


def main(argv=None):
    enable_compile_cache()
    args = parse_args("Input/input_ablation_case1.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
