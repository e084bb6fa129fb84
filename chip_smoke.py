#!/usr/bin/env python3
"""Smoke run of cmfem's main path on an NVIDIA GPU, checked against plain
references.

    python chip_smoke.py                # one GPU: device, apply, solve, driver
    python chip_smoke.py --four-cards   # four GPUs: the sharded paths only

Phases (each prints one line per case, and raises on a failed check):

- device: ``nvidia-smi`` name and power limit, JAX's device kind and
  default matmul precision, and the streaming bandwidth and FP32/FP64
  mul-add rates measured here.  No peak of any device is assumed.
- apply: the 3D convection-diffusion-reaction operator through
  ``SumFactoredOperator`` in float32 at orders 2/3/4 and one >= 10M-DOF
  case; both XLA apply paths are timed, and ``best_bind()`` is checked
  against ``BilinearForm.apply`` in float64 (the element gather /
  segment-sum path, independent of sum factorization).
- solve: ``StructuredMG``-preconditioned CG on the 3D Poisson operator in
  float32; the true residual is recomputed in float64 outside the solver.
- driver: ``apps.diffusion_mms.run`` and ``apps.linear_cd_2d.run`` with
  ``linear_solver: mg`` at order 3 on a unit-square GMSH mesh written
  here, refined to >= 0.5M DOFs; final L2 errors are pinned to a float64
  CPU run of the same configs.
- four-cards: element-sharded and DOF-partitioned CG and the z-sharded
  sum-factorized apply on a 1-axis 4-device mesh, each against the
  single-device result in float64.

Nothing is caught: any failed phase ends the process with a non-zero exit
code before the last line, which is the JSON
``{"ok": true, "device": {...}}``.  On anything but a GPU it exits 1
before the first phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# order-2 CDR apply (bench.py's operator); orders 3 and 4 at the sizes
# the benchmark uses, and one case of >= 10M DOFs
APPLY_CASES = ((2, 48), (3, 48), (4, 32), (2, 112))
SOLVE_CASES = ((2, 48), (3, 48))
# final L2 errors of the driver configs below (base 8x8 square, 5
# refinements, order 3: 591,361 DOFs), from a float64 run on the CPU
PINNED_L2 = {"diffusion_mms": 1.5238462192161325e-06,
             "linear_cd_2d": 1.9349090317947112e-05}
ITERS = 50


def smi_name_power() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _median_time(fn, *args, reps: int = 5) -> float:
    """Median seconds of one call of a jitted fn, after a warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def measure_bandwidth(nbytes: int = 1 << 30, iters: int = 20) -> float:
    """Bytes/s of a streaming read + write (y = x + c) over ``nbytes``."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros(nbytes // 4, jnp.float32)

    @jax.jit
    def stream(x, c):
        return jax.lax.fori_loop(0, iters, lambda _, x: x + c, x)

    t = _median_time(stream, x, jnp.float32(1.0)) / iters
    return 2 * x.size * 4 / t


def measure_muladd(dtype, n: int = 1 << 22, depth: int = 512,
                   iters: int = 20) -> float:
    """Flop/s of dependent mul-add chains (2 flops each), one per element
    of an ``n``-element array that stays in L2."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones(n, dtype)

    @jax.jit
    def chains(x, a, b):
        def body(_, x):
            for _ in range(depth):
                x = x * a + b
            return x
        return jax.lax.fori_loop(0, iters, body, x)

    t = _median_time(chains, x, jnp.asarray(0.999, dtype),
                     jnp.asarray(1e-3, dtype))
    return 2.0 * depth * n * iters / t


def phase_device(copy_bytes: int = 1 << 30, fma_n: int = 1 << 22) -> dict:
    import jax

    dev = jax.devices()[0]
    out = {
        "device_kind": dev.device_kind,
        "matmul_precision": jax.config.jax_default_matmul_precision,
        "bandwidth_GBps": measure_bandwidth(copy_bytes) / 1e9,
        "fp32_muladd_TFLOPs": measure_muladd(np.float32, fma_n) / 1e12,
        "fp64_muladd_TFLOPs": measure_muladd(np.float64, fma_n) / 1e12,
    }
    print("device " + " ".join(f"{k}={v}" for k, v in out.items()),
          flush=True)
    return out


def _cdr_form(ops):
    from cmfem_tpu.ops import BilinearForm

    return (BilinearForm(ops)
            .add_diffusion(0.1)
            .add_convection(np.array([1.0, -2.0, 0.5]))
            .add_mass(1.0))


def _structured_problem(n: int, order: int, make_form):
    """(fes, ops, form, data, grid) on the (n, n, n) unit cube."""
    from cmfem_tpu.core import FESpace, make_cartesian_mesh_3d
    from cmfem_tpu.ops import SpaceOps
    from cmfem_tpu.ops.partial import StructuredGrid3D

    fes = FESpace(make_cartesian_mesh_3d(n, n, n), order)
    ops = SpaceOps(fes, quad_order=2 * order)
    form = make_form(ops)
    return fes, ops, form, form.assemble(), StructuredGrid3D(n, n, n, order)


def _apply_loop(fn):
    """A jitted loop of ITERS chained applies: the damped feedback keeps
    values finite and stops XLA from hoisting the loop body."""
    import jax

    @jax.jit
    def many(u, D):
        return jax.lax.fori_loop(
            0, ITERS, lambda _, u: 0.25 * fn(u, D) + 1e-30 * u, u)

    return many


def phase_apply(cases=APPLY_CASES, bandwidth: float | None = None,
                tol: float = 1e-5, reps: int = 5) -> list:
    """Time both sum-factorized XLA paths per case and check
    ``best_bind()`` in float32 against the float64 element apply."""
    import jax
    import jax.numpy as jnp

    from cmfem_tpu.ops.sumfact import SumFactoredOperator

    results = []
    for order, n in cases:
        t0 = time.perf_counter()
        fes, ops, form, data, grid = _structured_problem(n, order, _cdr_form)
        sfop = SumFactoredOperator(ops, data, n, n, n, order,
                                   dtype=jnp.float32)
        lat = grid.lattice_index(fes.node_positions)
        setup_s = time.perf_counter() - t0

        rng = np.random.default_rng(order * 1000 + n)
        u_ent = rng.standard_normal(fes.nscalar)
        y_ref = np.asarray(form.apply(data, jnp.asarray(u_ent)))
        del data
        u_lat = np.zeros(grid.ndofs)
        u_lat[lat] = u_ent
        y_ref_lat = np.zeros(grid.ndofs)
        y_ref_lat[lat] = y_ref
        u32 = jnp.asarray(u_lat, jnp.float32)

        paths = {"plain": False}
        if sfop.z_periodic and sfop.compressed:
            paths["periodic"] = True
        _, D_best = sfop.best_bind()
        best = "periodic" if D_best is sfop.Dz else "plain"
        rec = {"order": order, "n": n, "ndofs": grid.ndofs,
               "setup_s": setup_s, "best": best, "paths": {}}
        for name, periodic in paths.items():
            fn, D = sfop.bind(use_periodic=periodic)
            y = np.asarray(jax.jit(fn)(u32, D), np.float64)
            err = float(np.abs(y - y_ref_lat).max() / np.abs(y_ref).max())
            t = _median_time(_apply_loop(fn), u32, D, reps=reps) / ITERS
            nbytes = sfop.min_bytes(periodic)
            p = {"err": err, "t_apply_s": t, "mdofs": grid.ndofs / t / 1e6,
                 "min_bytes": nbytes, "GBps": nbytes / t / 1e9}
            if bandwidth:
                p["bw_share"] = nbytes / t / bandwidth
            rec["paths"][name] = p
            print(f"apply order={order} n={n} ndofs={grid.ndofs} "
                  f"setup_s={setup_s:.1f} path={name} "
                  + " ".join(f"{k}={v}" for k, v in p.items()), flush=True)
            if not err <= tol:
                raise AssertionError(
                    f"apply order={order} n={n} {name}: f32 error {err} "
                    f"vs the f64 reference exceeds {tol}")
        print(f"apply order={order} n={n} best_bind={best}", flush=True)
        results.append(rec)
    return results


def _poisson_form(ops):
    from cmfem_tpu.ops import BilinearForm

    return BilinearForm(ops).add_diffusion(1.0)


def phase_solve(cases=SOLVE_CASES, rtol: float = 1e-6,
                true_tol: float = 2e-6, maxiter: int = 200) -> list:
    """MG-preconditioned CG in float32 on the Dirichlet Poisson operator,
    with its true residual recomputed in float64."""
    import jax
    import jax.numpy as jnp

    from cmfem_tpu.solvers import cg
    from cmfem_tpu.solvers.multigrid import StructuredMG

    results = []
    for order, n in cases:
        t0 = time.perf_counter()
        mg = StructuredMG.build(n, order, _poisson_form)
        lvl0 = mg.levels[0]
        fn0, D0 = lvl0["op"].best_bind()
        mask = lvl0["mask"]
        Mmg, arrs = mg.bind()
        setup_s = time.perf_counter() - t0
        ndofs = int(mask.shape[0])
        # white-noise load with homogeneous Dirichlet walls
        b64 = np.random.default_rng(n + order).standard_normal(ndofs)
        b64[np.asarray(mask)] = 0.0
        b = jnp.asarray(b64, jnp.float32)

        @jax.jit
        def solve(b, D, mask, arrs):
            A = lambda v: jnp.where(mask, v, fn0(jnp.where(mask, 0.0, v), D))
            return cg(A, b, M=lambda r: Mmg(r, arrs), rtol=rtol,
                      maxiter=maxiter)

        r = solve(b, D0, mask, arrs)
        jax.block_until_ready(r.x)
        t1 = time.perf_counter()
        r = solve(b, D0, mask, arrs)
        jax.block_until_ready(r.x)
        solve_s = time.perf_counter() - t1

        # true residual in float64 through the element apply
        fes, _, form, data, grid = _structured_problem(n, order,
                                                       _poisson_form)
        lat = grid.lattice_index(fes.node_positions)
        x = np.asarray(r.x, np.float64)
        on = np.asarray(mask)
        x_in = np.where(on, 0.0, x)
        ax = np.zeros(ndofs)
        ax[lat] = np.asarray(form.apply(data, jnp.asarray(x_in[lat])))
        res = b64 - np.where(on, x, ax)
        true_rel = float(np.linalg.norm(res) / np.linalg.norm(b64))
        rec = {"order": order, "n": n, "ndofs": ndofs,
               "iters": int(r.iters), "converged": bool(r.converged),
               "true_rel_residual": true_rel, "setup_s": setup_s,
               "solve_s": solve_s}
        print("solve " + " ".join(f"{k}={v}" for k, v in rec.items()),
              flush=True)
        if not (rec["converged"] and true_rel <= true_tol):
            raise AssertionError(
                f"MG-CG order={order} n={n}: converged={rec['converged']}, "
                f"true residual {true_rel} (limit {true_tol})")
        results.append(rec)
    return results


def write_unit_square_msh(path: str, nb: int) -> None:
    """GMSH v2.2 mesh of the unit square: nb x nb squares, each cut into
    two triangles; boundary lines tagged 1 bottom, 2 right, 3 top,
    4 left."""
    vid = lambda i, j: j * (nb + 1) + i + 1
    xs = np.linspace(0.0, 1.0, nb + 1)
    nodes = [f"{vid(i, j)} {xs[i]:.17g} {xs[j]:.17g} 0"
             for j in range(nb + 1) for i in range(nb + 1)]
    elems = []
    for k in range(nb):
        elems.append((1, 1, (vid(k, 0), vid(k + 1, 0))))
        elems.append((1, 2, (vid(nb, k), vid(nb, k + 1))))
        elems.append((1, 3, (vid(nb - k, nb), vid(nb - k - 1, nb))))
        elems.append((1, 4, (vid(0, nb - k), vid(0, nb - k - 1))))
    for j in range(nb):
        for i in range(nb):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), \
                vid(i, j + 1)
            elems.append((2, 1, (a, b, c)))
            elems.append((2, 1, (a, c, d)))
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat",
             "$Nodes", str(len(nodes)), *nodes, "$EndNodes",
             "$Elements", str(len(elems))]
    lines += [f"{e + 1} {t} 2 {tag} {tag} " + " ".join(map(str, vs))
              for e, (t, tag, vs) in enumerate(elems)]
    lines += ["$EndElements"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def driver_configs(mesh_file: str, out_dir: str, ref_levels: int = 5,
                   order: int = 3, steps: int = 3) -> dict:
    """The two driver configs of the driver phase, as YAML decks give
    them to ``run(cfg)``."""
    common = {"mesh_file": mesh_file, "order": order,
              "serial_ref_levels": ref_levels, "linear_solver": "mg",
              "save_paraview": False}
    return {
        "diffusion_mms": {**common, "dt": 0.01, "t_final": 0.01 * steps,
                          "output_path": os.path.join(out_dir, "mms")},
        # a high-frequency manufactured solution keeps the discretization
        # error (~1e-5 relative) far above the solver's algebraic error,
        # so the L2 error is reproducible to 1e-6 across machines
        "linear_cd_2d": {**common, "mode_n": 32, "mode_m": 32,
                         "output_path": os.path.join(out_dir, "cd2d")},
    }


def phase_driver(out_dir: str, base_n: int = 8, ref_levels: int = 5,
                 order: int = 3, steps: int = 3, pinned=PINNED_L2,
                 rel_tol: float = 1e-6) -> dict:
    """Both drivers through ``run(cfg)``; final L2 errors against
    ``pinned`` (skipped for a config whose pin is None)."""
    from cmfem_tpu.apps import diffusion_mms, linear_cd_2d

    os.makedirs(out_dir, exist_ok=True)
    mesh_file = os.path.join(out_dir, "unit_square.msh")
    write_unit_square_msh(mesh_file, base_n)
    cfgs = driver_configs(mesh_file, out_dir, ref_levels, order, steps)
    runs = {"diffusion_mms": (diffusion_mms.run, "final_l2"),
            "linear_cd_2d": (linear_cd_2d.run, "abs_l2")}
    results = {}
    for name, (run, key) in runs.items():
        t0 = time.perf_counter()
        out = run(cfgs[name])
        l2 = float(out[key])
        rec = {"ndofs": int(out["fes"].nscalar), "l2": l2,
               "wall_s": time.perf_counter() - t0}
        ref = pinned.get(name) if pinned else None
        if ref is not None:
            rec["rel_vs_pinned"] = abs(l2 - ref) / abs(ref)
        print(f"driver {name} " + " ".join(f"{k}={v!r}"
                                           for k, v in rec.items()),
              flush=True)
        if not np.isfinite(l2):
            raise AssertionError(f"driver {name}: L2 error {l2}")
        if ref is not None and not rec["rel_vs_pinned"] <= rel_tol:
            raise AssertionError(
                f"driver {name}: L2 {l2!r} vs pinned {ref!r} differs by "
                f"{rec['rel_vs_pinned']} (limit {rel_tol})")
        results[name] = rec
    return results


def phase_four_cards(n: int = 48, order: int = 2, ndev: int = 4,
                     rtol: float = 1e-10, tol: float = 1e-6) -> dict:
    """The multi-device paths on a 1-axis ``ndev``-device mesh, each
    against the single-device result in float64."""
    import jax
    import jax.numpy as jnp

    from cmfem_tpu.ops import BilinearForm
    from cmfem_tpu.ops.partial import PAOperator
    from cmfem_tpu.ops.sumfact import SumFactoredOperator
    from cmfem_tpu.ops.sumfact_sharded import ShardedSumFactOperator
    from cmfem_tpu.parallel import (
        DofPartitionedOperator, ShardedPoissonApply, make_device_mesh,
    )
    from cmfem_tpu.solvers import cg

    spd = lambda ops: BilinearForm(ops).add_mass(1.0).add_diffusion(0.1)
    fes, ops, form, data, grid = _structured_problem(n, order, spd)
    dinv = 1.0 / np.asarray(form.assemble_diagonal(data))
    b = np.random.default_rng(7).standard_normal(fes.nscalar)
    maxiter = 4000
    dev_mesh = make_device_mesh(ndev)
    out = {"ndofs": fes.nscalar}

    def rel(a, ref):
        return float(np.abs(np.asarray(a) - ref).max() / np.abs(ref).max())

    # single-device reference: the element apply on device 0
    fn, Dflat, eldofs = PAOperator(ops, data, dtype=jnp.float64).bind()
    ref_x = jax.jit(lambda b, Dflat, eldofs, dinv: cg(
        lambda v: fn(v, Dflat, eldofs), b, M=lambda r: dinv * r, rtol=rtol,
        maxiter=maxiter))(jnp.asarray(b), Dflat, eldofs, jnp.asarray(dinv))
    x_ref = np.asarray(ref_x.x)

    # element-sharded apply, replicated vectors
    A_sh = ShardedPoissonApply(ops, data, dev_mesh)
    blocks = [v for v in (A_sh.d00, A_sh.d01, A_sh.d10, A_sh.d11)
              if v is not None]
    r_sh = jax.jit(lambda b, dinv, eld, *blk: cg(
        lambda v: A_sh._apply(eld, v, *blk), b, M=lambda r: dinv * r,
        rtol=rtol, maxiter=maxiter))(jnp.asarray(b), jnp.asarray(dinv),
                                     A_sh.eldofs, *blocks)
    out["element_sharded_cg_rel"] = rel(r_sh.x, x_ref)

    # DOF-partitioned vectors (owned slabs + interface halo exchange)
    dop = DofPartitionedOperator(ops, data, dev_mesh)
    args = (dop.eldofs_loc, dop.pub_src, dop.pub_dst, dop.pub_src_rev,
            dop.ghost_src, *dop.blocks)
    r_dp = jax.jit(lambda b, dinv, *a: cg(
        lambda v: dop._apply(v, *a), b, M=lambda r: dinv * r, rtol=rtol,
        maxiter=maxiter))(dop.to_dist(b), dop.to_dist(dinv), *args)
    out["dof_partitioned_cg_rel"] = rel(dop.from_dist(r_dp.x), x_ref)
    out["cg_iters"] = [int(ref_x.iters), int(r_sh.iters), int(r_dp.iters)]
    del A_sh, dop, blocks, args

    # z-sharded sum-factorized apply of the CDR operator
    fes, ops, form, data, grid = _structured_problem(n, order, _cdr_form)
    zmesh = make_device_mesh(ndev, axis="z")
    shop = ShardedSumFactOperator(ops, data, n, n, n, order, zmesh,
                                  dtype=jnp.float64)
    u = np.random.default_rng(8).standard_normal(grid.ndofs)
    fn1, D1 = SumFactoredOperator(ops, data, n, n, n, order,
                                  dtype=jnp.float64).bind()
    y1 = np.asarray(jax.jit(fn1)(jnp.asarray(u), D1))
    ys = shop.from_sharded(jax.jit(shop._apply)(shop.to_sharded(u), shop.D))
    out["sumfact_sharded_apply_rel"] = rel(ys, y1)
    print("four_cards " + " ".join(f"{k}={v}" for k, v in out.items()),
          flush=True)
    for k in ("element_sharded_cg_rel", "dof_partitioned_cg_rel",
              "sumfact_sharded_apply_rel"):
        if not out[k] <= tol:
            raise AssertionError(f"four_cards {k}={out[k]} exceeds {tol}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded phase")
    ap.add_argument("--out-dir", default=None,
                    help="where the driver phase writes its mesh and CSVs "
                         "(default: a temporary directory)")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}",
              file=sys.stderr)
        return 1
    import cmfem_tpu  # noqa: F401  (x64 on, matmul precision highest)
    from cmfem_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(f"nvidia-smi {smi_name_power()}", flush=True)
    if args.four_cards:
        phase_four_cards()
    else:
        dev = phase_device()
        phase_apply(bandwidth=dev["bandwidth_GBps"] * 1e9)
        phase_solve()
        with tempfile.TemporaryDirectory() as tmp:
            phase_driver(args.out_dir or tmp)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
