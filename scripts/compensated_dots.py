"""Compensated-dot CG experiment (VERDICT r2 weak #7 / next-round #8).

BASELINE.json's 1e-8 rel-L2 north star holds in f64 on CPU; the chip runs
f32.  This experiment measures whether compensated (Neumaier) inner
products in CG buy any on-chip accuracy back, or whether f32 operator
application dominates the error (in which case compensated dots are
rejected with numbers — recorded in PARITY.md).

Protocol: the 3D CDR SPD system (mass + diffusion, order 2, n^3 hexes,
Dirichlet walls) is solved three ways —
  oracle : f64 CG on CPU, rtol 1e-12          (mode "oracle", saves x_ref)
  plain  : f32 CG, jnp.vdot                   (mode "f32")
  comp   : f32 CG, solvers.krylov.neumaier_dot (mode "f32")
and the f32 solutions' rel-L2 deviation from the oracle plus their CG
iteration counts are reported.  Run mode "f32" on the GPU for the on-device
numbers.

  python scripts/compensated_dots.py oracle   # CPU, writes /tmp/cd_ref.npz
  python scripts/compensated_dots.py f32      # current platform
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N = int(os.environ.get("CD_N", "24"))
ORDER = 2
REF_NPZ = os.environ.get("CD_REF", "/tmp/cd_ref.npz")


def build(dtype):
    import jax.numpy as jnp
    import numpy as np

    from cmfem_tpu.core import FESpace, make_cartesian_mesh_3d
    from cmfem_tpu.ops import SpaceOps, BilinearForm, EssentialBC

    mesh = make_cartesian_mesh_3d(N, N, N)
    fes = FESpace(mesh, ORDER)
    ops = SpaceOps(fes, quad_order=2 * ORDER)
    form = BilinearForm(ops).add_mass(1.0).add_diffusion(0.1)
    data = form.assemble()
    bc = EssentialBC(fes.nscalar, fes.boundary_dofs())
    diag = form.assemble_diagonal(data)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(fes.nscalar)
    b[np.asarray(bc.ess_dofs)] = 0.0

    def apply_A(v):
        av = form.apply(data, v)
        return jnp.where(bc.mask, v, av)

    Mdiag = jnp.asarray(np.where(np.asarray(bc.mask), 1.0,
                                 np.asarray(diag)), dtype)
    return fes, apply_A, jnp.asarray(b, dtype), Mdiag


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "f32"
    if mode == "oracle":
        os.environ["CMFEM_X64"] = "1"
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        os.environ.setdefault("CMFEM_X64", "0")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cmfem_tpu.solvers import cg, jacobi_preconditioner
    from cmfem_tpu.solvers.krylov import neumaier_dot

    if mode == "oracle":
        fes, apply_A, b, Mdiag = build(jnp.float64)
        res = cg(apply_A, b, M=jacobi_preconditioner(Mdiag), rtol=1e-12,
                 maxiter=3000)
        assert bool(res.converged)
        np.savez(REF_NPZ, x=np.asarray(res.x), b=np.asarray(b),
                 iters=int(res.iters))
        print(json.dumps({"mode": "oracle", "iters": int(res.iters),
                          "ndofs": fes.nscalar, "ref": REF_NPZ}))
        return 0

    ref = np.load(REF_NPZ)
    x_ref = ref["x"]
    fes, apply_A, b, Mdiag = build(jnp.float32)
    assert np.allclose(np.asarray(b), ref["b"], atol=1e-6)

    out = {"mode": "f32", "platform": jax.devices()[0].platform,
           "ndofs": fes.nscalar, "oracle_iters": int(ref["iters"])}
    for name, dotfn in (("plain_vdot", None),
                        ("neumaier", neumaier_dot)):
        solve = jax.jit(lambda b, d=dotfn: cg(
            apply_A, b, M=jacobi_preconditioner(Mdiag), rtol=3e-7,
            maxiter=3000, dot=d))
        res = solve(b)
        jax.block_until_ready(res.x)
        import time
        t0 = time.perf_counter()
        res = solve(b)
        jax.block_until_ready(res.x)
        dt = time.perf_counter() - t0
        dev = float(np.linalg.norm(np.asarray(res.x, np.float64) - x_ref)
                    / np.linalg.norm(x_ref))
        out[name] = {"iters": int(res.iters),
                     "converged": bool(res.converged),
                     "rel_l2_vs_f64_oracle": dev,
                     "solve_s": round(dt, 4)}
    p = out["plain_vdot"]["rel_l2_vs_f64_oracle"]
    c = out["neumaier"]["rel_l2_vs_f64_oracle"]
    out["accuracy_gain_factor"] = round(p / max(c, 1e-300), 3)
    print(json.dumps(out))
    path = os.path.join(REPO, "artifacts_compensated_dots.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
