"""Steady convection-diffusion-reaction on the unit disk (radial MMS).

Mirrors /root/reference/myapps/convection_diffusion/
linear_convection_diffusion_2D_circle.cpp: u_exact(r) = (r^2-1) cos(2 pi r),
f = -kappa Lap(u) + c . grad(u) + s u; kappa=1, s=1, c=(1,1) defaults.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .common import (
    parse_args, load_mesh_from_cfg, echo_config,
    ensure_outdir, validate_unit_circle, check_standalone_linear,
)
from ..utils.compile_cache import enable_compile_cache
from ..utils.yamlcfg import load_yaml
from ..io import CsvWriter, VTUCollection

_ALPHA = 2.0 * np.pi
_SMALL_R = 1.0e-12


def exact_u(r):
    return (r * r - 1.0) * np.cos(_ALPHA * r)


def exact_u_r(r):
    return 2.0 * r * np.cos(_ALPHA * r) - _ALPHA * (r * r - 1.0) * np.sin(_ALPHA * r)


def exact_u_rr(r):
    return (2.0 * np.cos(_ALPHA * r) - 4.0 * _ALPHA * r * np.sin(_ALPHA * r)
            - _ALPHA * _ALPHA * (r * r - 1.0) * np.cos(_ALPHA * r))


def exact_laplacian(r):
    r = np.asarray(r)
    safe = np.where(r > _SMALL_R, r, 1.0)
    lap = exact_u_rr(r) + exact_u_r(safe) / safe
    # r -> 0 limit by symmetry: Lap = 2 u_rr(0)
    return np.where(r > _SMALL_R, lap, 2.0 * exact_u_rr(0.0))


def make_mms(kappa, s, cx, cy):
    def exact(x):
        return exact_u(np.linalg.norm(x, axis=1))

    def forcing(x):
        r = np.linalg.norm(x, axis=1)
        u = exact_u(r)
        lap = exact_laplacian(r)
        safe = np.where(r > _SMALL_R, r, 1.0)
        rs = np.where(r > _SMALL_R, exact_u_r(r) / safe, 0.0)
        ux, uy = rs * x[:, 0], rs * x[:, 1]
        return -kappa * lap + cx * ux + cy * uy + s * u

    return exact, forcing


def run(cfg: dict) -> dict:
    import jax.numpy as jnp

    from ..core import FESpace
    from ..ops import (
        SpaceOps, BilinearForm, EssentialBC, domain_lf, l2_error, l2_norm_fn,
    )
    from ..solvers import gmres, jacobi_preconditioner

    order = int(cfg.get("order", 1))
    kappa = float(cfg.get("kappa", 1.0))
    s = float(cfg.get("s", 1.0))
    cx = float(cfg.get("cx", 1.0))
    cy = float(cfg.get("cy", 1.0))
    if "convection" in cfg:
        cx, cy = [float(v) for v in cfg["convection"]]
    output_path = cfg.get("output_path", "ParaView")
    collection_name = cfg.get("collection_name", "convection_diffusion_2D_circle")
    error_csv = cfg.get("error_csv", "error_history_2D_circle.csv")
    save_paraview = bool(cfg.get("save_paraview", True))
    if kappa <= 0:
        raise ValueError("kappa must be > 0.")

    mesh = load_mesh_from_cfg(cfg)
    validate_unit_circle(mesh)
    fes = FESpace(mesh, order)
    print(f"Global true dofs: {fes.nscalar}")

    exact, forcing = make_mms(kappa, s, cx, cy)
    ops = SpaceOps(fes)
    a = (BilinearForm(ops)
         .add_diffusion(kappa)
         .add_convection(np.array([cx, cy]))
         .add_mass(s))
    data = a.assemble()
    b = domain_lf(ops, forcing)

    bc = EssentialBC(fes.nscalar, fes.boundary_dofs())
    u_bc = jnp.asarray(fes.project_bdr(np.zeros(fes.nscalar), exact))
    apply_A = lambda v: a.apply(data, v)
    B = bc.constrained_rhs(apply_A, b, u_bc)
    M = jacobi_preconditioner(jnp.where(bc.mask, 1.0, a.assemble_diagonal(data)))
    res = gmres(bc.constrain_operator(apply_A), B, M=M,
                rtol=float(cfg.get("solver_rtol", 1e-12)),
                restart=int(cfg.get("solver_restart", 100)),
                maxiter=int(cfg.get("solver_maxiter", 80)))
    check_standalone_linear(res)
    u = res.x

    abs_l2 = float(l2_error(ops, u, exact))
    exact_l2 = float(l2_norm_fn(ops, exact))
    rel_l2 = abs_l2 / exact_l2 if exact_l2 > 1e-14 else 0.0
    print(f"L2 error (absolute): {abs_l2}")
    print(f"L2 error (relative): {rel_l2}")

    ensure_outdir(output_path)
    with CsvWriter(os.path.join(output_path, error_csv),
                   ["abs_l2", "rel_l2"]) as w:
        w.writerow([abs_l2, rel_l2])

    if save_paraview:
        dc = VTUCollection(collection_name, fes, prefix_path=output_path)
        dc.save(0, 0.0, {"u": np.asarray(u), "u_exact": fes.interpolate(exact)})

    return {"abs_l2": abs_l2, "rel_l2": rel_l2, "u": np.asarray(u), "fes": fes}


def main(argv=None):
    enable_compile_cache()
    args = parse_args("Input/input_2d_circle.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
