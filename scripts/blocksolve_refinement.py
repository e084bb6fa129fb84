"""Refinement-robustness study of the MUMPS replacement (VERDICT r2 #4).

The reference solves every ablation Newton system with a distributed
direct LU (MUMPS, Input/petsc_ablation*.opts) because the coupled (T, p)
block system is badly conditioned (~1e9 scale disparity).  The
replacement is the equilibrated 2x2 point-block GMRES
(solvers/blocksolve.py).  This study measures its restart cycles and
TOTAL inner Krylov iterations on the case-2.2 system at 1x/2x/4x strip
refinement, for two representative states:

  heating  : step-1 regime — cold interior, 1,600 K convective-heating
             surface flux branch (chemistry_blowing)
  char+cool: late-transient regime — charred top (extents = 1 within
             ~1.5 mm), hot subsurface with a cooled 700 K wall
             (cooling_standard branch), and >= 1 mm of recession applied
             to the mesh (graded node pull-down)

Round-4 finding: the point-block PC grows ~2.7x per refinement (not
h-robust), and measuring it at refine >= 2 blew the single-program
watchdog.  Round 5 adds the h-robust replacement — the line-MG PC
(solvers/linemg.py: x-semicoarsened multigrid with exact y-line
smoothing) — and this study now measures BOTH: linemg at every
refinement (short, watchdog-safe programs by construction) and
pointblock at refine <= 1 as the contrast.  Run standalone
(`python scripts/blocksolve_refinement.py`) or as the bench's
`blocksolve_refinement` section (BENCH_BLOCKSOLVE=1).
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference/myapps/convection_diffusion"
sys.path.insert(0, REPO)


def make_states(fes, sys_, mat, n, verts0):
    """Two (name, T, p, X, verts) synthetic states spanning the run."""
    import numpy as np

    pos = np.asarray(fes.node_positions)
    ytop = pos[:, 1].max()
    depth = ytop - pos[:, 1]

    # per-QP depth for the extent fields
    import jax.numpy as jnp
    xq = np.asarray(sys_.ops.gf.xq)  # (ne, nq, dim)
    dq = ytop - xq[..., 1]
    nr = mat.num_reactions

    # heating: cold interior, hot thermal boundary layer (~2 mm)
    T_heat = 300.0 + 1300.0 * np.exp(-depth / 2e-3)
    X_heat = np.clip(np.exp(-dq / 1e-3), 0.0, 1.0)[..., None] \
        * np.ones(nr)
    X_heat = 0.3 * X_heat  # partially reacted

    # char + cooldown: fully charred top, subsurface peak, cooled wall
    T_cool = (300.0 + 400.0 * np.exp(-depth / 2e-3)
              + 700.0 * np.exp(-((depth - 4e-3) / 3e-3) ** 2))
    X_cool = np.clip(1.0 - dq / 1.5e-3, 0.0, 1.0)
    X_cool = np.maximum(X_cool[..., None] * np.ones(nr),
                        np.clip(np.exp(-dq / 3e-3), 0.0, 1.0)[..., None]
                        * 0.99)

    # recession >= 1 mm: graded pull-down, strongest at the top
    verts_rec = np.asarray(verts0).copy()
    vdepth = ytop - verts_rec[:, 1]
    verts_rec[:, 1] -= 1.2e-3 * np.exp(-vdepth / (0.4 * ytop))

    p0 = np.full(n, 101325.0)
    return [
        ("heating", T_heat, p0, X_heat, np.asarray(verts0), 1),
        ("char_cooldown", T_cool, p0, X_cool, verts_rec, 0),
    ]


def run_study(refinements=(0, 1, 2, 3), rtol=1e-6, dt=0.0025,
              restart=400, maxiter=10, pointblock_max_refine=1):
    """Measure both preconditioners under strip refinement:

    - ``linemg`` (solvers/linemg.py: x-semicoarsened MG + exact y-line
      smoothing) at EVERY refinement — the h-robust path; solves are
      tens of inner iterations, so every program is short and
      watchdog-safe by construction (VERDICT r4 #1).
    - ``pointblock`` at refinements <= ``pointblock_max_refine`` with
      the historical restart=400 budget — the contrast data showing
      the ~2.7x/level growth that motivated linemg (measuring it at
      refine >= 2 is what blew the round-4 single-program watchdog).
    """
    import time as _time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from cmfem_tpu.core import FESpace, load_gmsh
    from cmfem_tpu.ops import SpaceOps
    from cmfem_tpu.physics.tacot import TacotMaterial
    from cmfem_tpu.physics.bprime import BPrimeTable
    from cmfem_tpu.physics.seb import SurfaceFluxModel, classify_branch
    from cmfem_tpu.physics.surface_bc import BoundaryState
    from cmfem_tpu.physics.ablation import AblationSystem
    from cmfem_tpu.solvers import BlockNewtonKrylov
    from cmfem_tpu.solvers.blocksolve import strip_dof_lattice

    mat = TacotMaterial.load_yaml(f"{REF}/Input/material_tacot_case2_2.yaml")
    model = SurfaceFluxModel(case22=True)
    bprime = BPrimeTable.synthetic_tacot()
    base_mesh = load_gmsh(f"{REF}/Mesh/ablation_strip.msh")

    out = {"rtol": rtol, "dt": dt, "restart": restart,
           "platform": jax.devices()[0].platform, "levels": []}
    for lvl in refinements:
        mesh = base_mesh.uniform_refine(lvl) if lvl else base_mesh
        fes = FESpace(mesh, 1)
        n = fes.nscalar
        ops = SpaceOps(fes, quad_order=4)
        sys_ = AblationSystem(ops, mat, top_attr=1)
        ess = np.asarray(fes.boundary_dofs([1]))
        mask2 = np.zeros(2 * n, dtype=bool)
        mask2[ess + n] = True
        mask2_j = jnp.asarray(mask2)
        try:
            lat = strip_dof_lattice(fes.node_positions)
        except ValueError:
            lat = None
        solvers = {"linemg": BlockNewtonKrylov(
            fes.element_dofs, n, np.zeros(0, dtype=np.int64), ess,
            restart=60, maxiter=5, dof_lattice=lat, pc="linemg")}
        if lvl <= pointblock_max_refine:
            solvers["pointblock"] = BlockNewtonKrylov(
                fes.element_dofs, n, np.zeros(0, dtype=np.int64), ess,
                restart=restart, maxiter=maxiter, dof_lattice=lat)
        face_elem = sys_.trace.elem

        rec = {"refine": lvl, "ndofs_tp": 2 * n, "states": {}}
        for (name, T_np, p_np, X_np, verts,
             chem) in make_states(fes, sys_, mat, n, mesh.vertices):
            T = jnp.asarray(T_np)
            p = jnp.asarray(p_np)
            X = jnp.asarray(np.broadcast_to(
                X_np.reshape(sys_.ne, sys_.nq, -1),
                (sys_.ne, sys_.nq, mat.num_reactions)).copy())
            v = jnp.asarray(verts)
            gf = ops.geometric_factors(v)
            bc = BoundaryState(p_w=101325.0,
                               rhoeUeCH=0.3 if chem else 0.003,
                               h_r=1.5e6 if chem else 0.0, hconv=0.0,
                               Tedge=300.0, has_hconv=False,
                               has_Tedge=False, chemistryOn=chem)
            branch = classify_branch(bc, model)
            To = ops.values_at_qp(T)
            po = ops.values_at_qp(p)

            def residual(T, p):
                RT, Rp = sys_.residual(T, p, To, po, X, dt, gf=gf)
                RT = RT + sys_.seb_face_residual(T, p, X, bc, branch,
                                                 model, bprime, vertices=v)
                return jnp.where(mask2_j, 0.0,
                                 jnp.concatenate([RT, Rp]))

            R = jax.jit(residual)(T, p)
            blocks = sys_.element_jacobians(T, p, To, po, X, dt, gf=gf)
            face = sys_.seb_face_jacobians(T, p, X, bc, branch, model,
                                           bprime, vertices=v)
            st = {"branch": branch}
            for pc_name, bks in solvers.items():
                fac = bks.prepare(blocks, face=face, face_elem=face_elem)
                res = bks.solve(fac, -R, rtol=rtol)      # warm/compile
                jax.block_until_ready(res.x)
                t0 = _time.perf_counter()
                fac = bks.prepare(blocks, face=face, face_elem=face_elem)
                res = bks.solve(fac, -R, rtol=rtol)
                jax.block_until_ready(res.x)
                wall = _time.perf_counter() - t0
                st[pc_name] = {
                    "cycles": int(res.iters),
                    "inner_iters": int(res.inner_iters),
                    "converged": bool(res.converged),
                    "prepare_plus_solve_s": round(wall, 4),
                    "rel_residual": float(
                        res.residual / max(1e-300,
                                           float(jnp.linalg.norm(R)))),
                }
                print(f"# refine={lvl} ndofs_tp={2*n} state={name} "
                      f"pc={pc_name} cycles={int(res.iters)} "
                      f"inner={int(res.inner_iters)} "
                      f"converged={bool(res.converged)} "
                      f"wall={wall:.3f}s", file=sys.stderr)
            rec["states"][name] = st
        out["levels"].append(rec)
        # flush after every level: a watchdog/timeout kill mid-study
        # keeps the completed levels (single-core host, long traces)
        with open(os.path.join(REPO,
                               "artifacts_blocksolve_refinement.partial.json"),
                  "w") as f:
            json.dump(out, f, indent=1)

    # growth factor per level for the h-robust path, worst state
    growth = {}
    for name in out["levels"][0]["states"]:
        iters = [lv["states"][name]["linemg"]["inner_iters"]
                 for lv in out["levels"]]
        growth[name] = {
            "linemg_inner_iters_by_level": iters,
            "linemg_growth_per_level": [
                round(b / max(1, a), 2) for a, b in zip(iters, iters[1:])],
        }
    out["linemg_growth"] = growth
    return out


def main():
    refs = tuple(int(a) for a in sys.argv[1:]) or (0, 1, 2, 3)
    study = run_study(refinements=refs)
    path = os.path.join(REPO, "artifacts_blocksolve_refinement.json")
    with open(path, "w") as f:
        json.dump(study, f, indent=1)
    print(json.dumps(study))
    return 0


if __name__ == "__main__":
    sys.exit(main())
