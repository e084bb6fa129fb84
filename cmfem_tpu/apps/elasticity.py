"""Linear elasticity: cantilever beam static solve (BASELINE config #5).

Vector-H1 (order 2 default) isotropic elasticity
  -div(sigma(u)) = f,  sigma = lam tr(eps) I + 2 mu eps,
clamped at x=0, end traction or body load; CG + (block-)Jacobi.  2D or 3D
(generated cantilever meshes).  Verified against the Euler-Bernoulli tip
deflection in tests.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .common import (parse_args, echo_config,
                     ensure_outdir, check_standalone_linear)
from ..utils.compile_cache import enable_compile_cache
from ..utils.yamlcfg import load_yaml
from ..io import CsvWriter, VTUCollection


def run(cfg: dict) -> dict:
    import jax.numpy as jnp

    from ..core import FESpace, make_cartesian_mesh_2d, make_cartesian_mesh_3d
    from ..ops import SpaceOps
    from ..ops.bc import EssentialBC
    from ..ops.vector import (
        VectorBilinearForm, vector_domain_lf, vector_boundary_lf,
    )
    from ..solvers import cg, jacobi_preconditioner

    dim = int(cfg.get("dim", 2))
    order = int(cfg.get("order", 2))
    L = float(cfg.get("length", 1.0))
    H = float(cfg.get("height", 0.1))
    nx = int(cfg.get("nx", 40))
    ny = int(cfg.get("ny", 4))
    nz = int(cfg.get("nz", 4))
    E = float(cfg.get("youngs_modulus", 1.0e6))
    nu = float(cfg.get("poisson_ratio", 0.3))
    tip_traction = float(cfg.get("tip_traction", -100.0))  # per unit area, y
    body_force_y = float(cfg.get("body_force_y", 0.0))
    output_path = cfg.get("output_path", "ParaView/elasticity")
    save_paraview = bool(cfg.get("save_paraview", True))

    # plane-strain Lame parameters (2D) / 3D Lame parameters
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))

    if dim == 2:
        mesh = make_cartesian_mesh_2d(nx, ny, sx=L, sy=H)
        left_attr, right_attr = 4, 2
    else:
        mesh = make_cartesian_mesh_3d(nx, ny, nz, sx=L, sy=H, sz=H)
        left_attr, right_attr = 6, 4
    fes = FESpace(mesh, order, vdim=dim)
    n = fes.nscalar
    print(f"Vector dofs: {n * dim}")
    ops = SpaceOps(fes)

    form = VectorBilinearForm(ops, vdim=dim).add_elasticity(lam, mu)
    C = form.assemble()

    b = jnp.zeros(n * dim)
    if body_force_y != 0.0:
        def body(x):
            f = np.zeros((len(x), dim))
            f[:, 1] = body_force_y
            return f

        b = b + vector_domain_lf(ops, body, vdim=dim)
    if tip_traction != 0.0:
        def traction(x):
            g = np.zeros((len(x), dim))
            g[:, 1] = tip_traction
            return g

        b = b + vector_boundary_lf(ops, traction, attr_marker=[right_attr],
                                   vdim=dim)

    ess_scalar = fes.boundary_dofs([left_attr])
    ess = np.concatenate([np.asarray(ess_scalar) + c * n for c in range(dim)])
    bc = EssentialBC(n * dim, ess)
    apply_A = lambda u: form.apply(C, u)
    B = bc.constrained_rhs(apply_A, b, jnp.zeros(n * dim))
    diag = jnp.where(bc.mask, 1.0, form.assemble_diagonal(C))
    res = cg(bc.constrain_operator(apply_A), B,
             M=jacobi_preconditioner(diag),
             rtol=float(cfg.get("solver_rtol", 1e-10)),
             maxiter=int(cfg.get("solver_maxiter", 5000)))
    check_standalone_linear(res, "CG")
    u = np.asarray(res.x)

    # tip deflection: mean u_y over the free-end boundary nodes
    tip_dofs = np.asarray(fes.boundary_dofs([right_attr]))
    tip_deflection = float(u[n + tip_dofs].mean())
    print(f"CG iterations: {int(res.iters)}")
    print(f"Tip deflection (mean u_y at x=L): {tip_deflection:.6e}")

    ensure_outdir(output_path)
    with CsvWriter(os.path.join(output_path, "elasticity_summary.csv"),
                   ["metric", "value"]) as w:
        w.writerow(["tip_deflection", tip_deflection])
        w.writerow(["cg_iterations", int(res.iters)])
        w.writerow(["dofs", n * dim])
    if save_paraview:
        dc = VTUCollection("elasticity", fes, prefix_path=output_path)
        disp = np.stack([u[c * n:(c + 1) * n] for c in range(dim)], axis=1)
        dc.save(0, 0.0, {"displacement": disp})

    return {"u": u, "tip_deflection": tip_deflection, "fes": fes,
            "iters": int(res.iters), "lam": lam, "mu": mu}


def main(argv=None):
    enable_compile_cache()
    args = parse_args("Input/input_elasticity.yaml", argv)
    cfg = load_yaml(args.input) if os.path.exists(args.input) else {}
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
