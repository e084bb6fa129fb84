"""Full-horizon production-deck runner (VERDICT r2 next-round #1).

Runs the VERBATIM reference production decks end-to-end on the current
JAX platform (the GPU by default; ``--cpu`` for the CPU):

  case1   : Input/input_ablation_case1.yaml     60 s, dt=0.1   ->   600 steps
  case2_1 : Input/input_ablation_case2_1.yaml  120 s, dt=0.1   -> 1,200 steps
            (crosses the t=60.1 s chemistry switch)
  case2_2 : Input/input_ablation_case2_2.yaml  120 s, dt=0.0025 -> 48,000
            steps with real recession on the refined tri strip
            (the reference's full-horizon loop,
            ablation_test_case2_2_2D.cpp:4060-4247)

Device-resident stepping (scan_stepping) is used so the run amortizes
dispatch; the schedule's chemistry/branch flip at 60.1 s is handled by the
scan path's per-(branch,chemistry) program segmentation.

Writes artifacts_fullrun_<case>.json at the repo root: wall-clock,
per-step Newton statistics, temperature bounds, pyrolysis-front motion,
recession history (2.2), minimum mesh quality (2.2), and physics-sanity
booleans.

Usage:
  python scripts/fullrun.py case1 [--t-final X] [--output-every N] [--cpu]
"""

import argparse
import json
import os
import platform as _platform
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference/myapps/convection_diffusion"
sys.path.insert(0, REPO)

os.environ.setdefault("CMFEM_X64", "0")

DECKS = {
    "case1": ("ablation_case1", "input_ablation_case1.yaml"),
    "case2_1": ("ablation_case2_1", "input_ablation_case2_1.yaml"),
    "case2_2": ("ablation_case2_2", "input_ablation_case2_2.yaml"),
}


def _col(rows, header, name):
    return [float(r[header.index(name)]) for r in rows]


def _read_csv(path):
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    header = lines[0].split(",")
    rows = [ln.split(",") for ln in lines[1:]]
    return header, rows


def summarize(case, out_dir, cfg, wall_s, run_out, platform, extra):
    art = {
        "case": case,
        "deck": f"{REF}/Input/{DECKS[case][1]}",
        "platform": platform,
        "hostname": _platform.node(),
        "dt": cfg["dt"],
        "t_final": cfg["t_final"],
        "wall_s": None if wall_s is None else round(wall_s, 2),
        **extra,
    }

    # Newton history: iterations per step + convergence
    nh_name = cfg.get("newton_csv", "newton_history.csv")
    nh = os.path.join(out_dir, nh_name)
    if os.path.isfile(nh):
        header, rows = _read_csv(nh)
        steps = {}
        for r in rows:
            s = int(float(r[header.index("step")]))
            it = int(float(r[header.index("iter")]))
            steps[s] = max(steps.get(s, 0), it + 1)
        iters = list(steps.values())
        art["n_steps"] = len(steps)
        art["newton_iters_mean"] = round(sum(iters) / max(1, len(iters)), 3)
        art["newton_iters_max"] = max(iters) if iters else 0
    art["ms_per_step"] = None if wall_s is None else round(
        1e3 * wall_s / max(1, art.get("n_steps", 1)), 2)

    # mass metrics: fronts, mdot peak, recession
    mm = os.path.join(out_dir, cfg.get("mass_csv", "mass_metrics.csv"))
    if os.path.isfile(mm):
        header, rows = _read_csv(mm)
        t = _col(rows, header, "time")
        mdot = _col(rows, header, "m_dot_g_surf")
        imax = max(range(len(mdot)), key=lambda i: mdot[i])
        art["mdot_g_peak"] = round(mdot[imax], 6)
        art["mdot_g_peak_time"] = t[imax]
        for key in ("front_98_virgin", "front_2_char"):
            if key in header:
                v = _col(rows, header, key)
                fin = [x for x in v if x == x]  # drop NaN
                art[f"{key}_final"] = round(fin[-1], 6) if fin else None
        if "recession" in header:
            rec = _col(rows, header, "recession")
            art["recession_final_m"] = rec[-1]
            art["recession_monotone"] = all(
                b >= a - 1e-12 for a, b in zip(rec, rec[1:]))

    # temperature probes: bounds over the whole run
    pr = os.path.join(out_dir, cfg.get("probes_csv",
                                       "temperature_probes.csv"))
    if os.path.isfile(pr):
        header, rows = _read_csv(pr)
        vals = [float(v) for r in rows for v in r[1:]
                if v not in ("", "nan") and float(v) == float(v)]
        art["T_min"] = round(min(vals), 2)
        art["T_max"] = round(max(vals), 2)

    # mesh quality (2.2)
    md = os.path.join(out_dir, cfg.get("meshdiag_csv",
                                       "mesh_diagnostics.csv"))
    if os.path.isfile(md):
        header, rows = _read_csv(md)
        if "min_quality_ratio" in header:
            q = _col(rows, header, "min_quality_ratio")
            art["min_quality_ratio"] = round(min(q), 4)

    art["sane"] = bool(
        art.get("n_steps", 0) > 0
        and art.get("T_max", 0) > 320.0
        and art.get("T_min", 0) >= 250.0
        and art.get("T_max", 1e9) < 4000.0
        and art.get("recession_monotone", True)
        and art.get("min_quality_ratio", 1.0) > 0.05)
    return art


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=sorted(DECKS))
    ap.add_argument("--t-final", type=float, default=None,
                    help="override horizon (smoke-testing the machinery)")
    ap.add_argument("--output-every", type=int, default=200,
                    help="scan chunk length (steps per XLA program call)")
    ap.add_argument("--eager", action="store_true",
                    help="host-stepped loop instead of scan_stepping")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--x64", action="store_true",
                    help="f64 run (CPU oracle); default f32 as on the chip")
    ap.add_argument("--newton-rel-tol", type=float, default=None)
    ap.add_argument("--newton-abs-tol", type=float, default=None)
    ap.add_argument("--gmres-maxiter", type=int, default=None)
    ap.add_argument("--gmres-restart", type=int, default=None)
    ap.add_argument("--linear-rtol", type=float, default=None,
                    help="GMRES relative tolerance (deck default 1e-10 "
                         "targets the f64 MUMPS-parity regime; ~1e-4 is "
                         "the inexact-Newton setting for f32 chips)")
    ap.add_argument("--lattice", action="store_true",
                    help="enable the window-slicing lattice residual")
    ap.add_argument("--stall-improve", type=float, default=0.01,
                    help="newton_stall_improve for the scan Newton loops: "
                         "an iteration counts as progress only if it "
                         "improves the residual by this fraction. The "
                         "library default (1e-3) lets f32 floor-creep "
                         "(~0.5%%/iter between 2.09 and 2.03) burn 13 "
                         "Newton iterations per step on the production "
                         "2.2 deck; 1%% exits ~3 iterations after real "
                         "progress stops. Healthy Newton steps improve "
                         "orders of magnitude per iteration and are "
                         "unaffected.")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--artifact", default=None)
    ap.add_argument("--summarize-only", action="store_true",
                    help="skip the run; rebuild the artifact JSON from the "
                         "CSVs already in --out-dir (flushed per row, so a "
                         "wall-clock-killed run still yields a partial "
                         "artifact)")
    ap.add_argument("--wall-s", type=float, default=None,
                    help="wall-clock to record with --summarize-only "
                         "(omitted -> wall_s/ms_per_step are null in the "
                         "artifact instead of a fake 0.0)")
    args = ap.parse_args()

    if args.x64:
        os.environ["CMFEM_X64"] = "1"
    if args.cpu or args.summarize_only:
        # summarize-only must never contend for the accelerator (another
        # run may still hold it); it only reads CSVs
        os.environ["JAX_PLATFORMS"] = "cpu"

    import importlib

    from cmfem_tpu.utils.compile_cache import enable_compile_cache

    import jax

    # persistent compile cache: long runs must not pay re-compiles
    enable_compile_cache()

    from cmfem_tpu.utils.yamlcfg import load_yaml

    mod_name, deck = DECKS[args.case]
    mod = importlib.import_module(f"cmfem_tpu.apps.{mod_name}")
    cfg = load_yaml(f"{REF}/Input/{deck}")

    out_dir = args.out_dir or os.path.join(REPO, "artifacts",
                                           f"fullrun_{args.case}")
    os.makedirs(out_dir, exist_ok=True)
    cfg.update(
        output_path=out_dir,
        save_paraview=False,
        scan_stepping=not args.eager,
        output_every=args.output_every,
        newton_print_level=0,
    )
    if args.t_final is not None:
        cfg["t_final"] = args.t_final
    if args.newton_rel_tol is not None:
        cfg["newton_rel_tol"] = args.newton_rel_tol
    if args.newton_abs_tol is not None:
        cfg["newton_abs_tol"] = args.newton_abs_tol
    if args.gmres_maxiter is not None:
        cfg["gmres_maxiter"] = args.gmres_maxiter
    if args.gmres_restart is not None:
        cfg["gmres_restart"] = args.gmres_restart
    if args.linear_rtol is not None:
        cfg["linear_rtol"] = args.linear_rtol
    if args.lattice:
        cfg["lattice_residual"] = True
    if args.stall_improve is not None:
        cfg["newton_stall_improve"] = args.stall_improve

    platform = jax.devices()[0].platform
    extra = {"scan_stepping": not args.eager,
             "x64": os.environ.get("CMFEM_X64") == "1"}
    overrides = {k: getattr(args, k) for k in
                 ("newton_rel_tol", "newton_abs_tol", "gmres_maxiter",
                  "gmres_restart", "linear_rtol", "stall_improve",
                  "output_every") if getattr(args, k) is not None}
    if overrides:
        extra["overrides"] = overrides
    if args.summarize_only:
        wall = args.wall_s
        run_out = {}
        extra["partial"] = True
    else:
        print(f"fullrun {args.case}: platform={platform} dt={cfg['dt']} "
              f"t_final={cfg['t_final']} scan={not args.eager}")
        t0 = time.perf_counter()
        run_out = mod.run(cfg)
        wall = time.perf_counter() - t0
        if args.case == "case2_2":
            extra["recession_total_m"] = float(
                run_out.get("recession_total", 0.0))
        # f32 floor-acceptance observability (VERDICT r4 #9): how many
        # steps exited Newton via the stall floor vs the tolerance, and
        # where those stalled residuals sat
        if run_out.get("newton_stall_stats"):
            extra["newton_stall_stats"] = run_out["newton_stall_stats"]
    art = summarize(args.case, out_dir, cfg, wall, run_out, platform, extra)
    path = args.artifact or os.path.join(REPO,
                                         f"artifacts_fullrun_{args.case}.json")
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps(art))
    print(f"wrote {path}")
    return 0 if art["sane"] else 1


if __name__ == "__main__":
    sys.exit(main())
