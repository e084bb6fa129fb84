"""Subprocess helper for the f32-vs-f64 ablation Newton comparison.

Run as: python f32newton_helper.py {32|64} /path/out.npz
Builds the small case-1 TACOT strip, runs 8 undamped Newton iterates of one
implicit step through the on-device equilibrated block-GMRES path
(``BlockNewtonKrylov``), and saves the final (T, p) fields + residual
history.  The 32 mode is the pure-f32 device configuration (CMFEM_X64=0);
64 is the parity oracle.
"""
import os
import sys


def main():
    mode, out = sys.argv[1], sys.argv[2]
    os.environ["CMFEM_X64"] = "1" if mode == "64" else "0"
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from cmfem_tpu.core import FESpace, make_cartesian_mesh_2d
    from cmfem_tpu.ops import SpaceOps
    from cmfem_tpu.physics.tacot import TacotMaterial
    from cmfem_tpu.physics.ablation import AblationSystem, AblationState
    from cmfem_tpu.solvers import BlockNewtonKrylov

    REF = "/root/reference/myapps/convection_diffusion"
    mesh = make_cartesian_mesh_2d(3, 12, sx=0.0025, sy=0.05)
    mat = TacotMaterial.load_yaml(f"{REF}/Input/material_tacot_case1.yaml")
    fes = FESpace(mesh, 1)
    n = fes.nscalar
    ops = SpaceOps(fes, quad_order=4)
    sys_ = AblationSystem(ops, mat, top_attr=3)
    state = AblationState.initial(sys_.ne, sys_.nq, mat)
    ess = np.asarray(fes.boundary_dofs([3]))
    dt = 0.05
    T = jnp.full(n, 300.0).at[jnp.asarray(ess)].set(1644.0)
    p = jnp.full(n, 101325.0)
    T_old_q = ops.values_at_qp(jnp.full(n, 300.0))
    p_old_q = ops.values_at_qp(p)
    X_old = state.extent
    mask2 = np.zeros(2 * n, dtype=bool)
    mask2[ess] = True
    mask2[ess + n] = True
    bks = BlockNewtonKrylov(fes.element_dofs, n, ess, ess, restart=200,
                            maxiter=10)
    hist = []
    best = (np.inf, T, p)
    for _ in range(8):
        RT, Rp = sys_.residual(T, p, T_old_q, p_old_q, X_old, dt)
        R = jnp.where(jnp.asarray(mask2), 0.0, jnp.concatenate([RT, Rp]))
        rn = float(jnp.linalg.norm(R))
        hist.append(rn)
        if rn < best[0]:
            best = (rn, T, p)
        blocks = sys_.element_jacobians(T, p, T_old_q, p_old_q, X_old, dt)
        res = bks.solve(bks.prepare(blocks), -R, rtol=1e-8)
        T = T + res.x[:n]
        p = p + res.x[n:]
    # report the BEST iterate: at the f32 floor undamped iterates
    # oscillate within noise of the floor, and the production Newton
    # loops stall-exit there instead of stepping past it
    _, T, p = best
    np.savez(out, T=np.asarray(T, np.float64), p=np.asarray(p, np.float64),
             hist=np.asarray(hist), dtype_bits=32 if mode == "32" else 64)


if __name__ == "__main__":
    main()
