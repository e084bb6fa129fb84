"""One-table accuracy story (VERDICT r2 weak #7 / next-round #8).

BASELINE.json's two north stars are met by two configurations: <=1e-8
rel-L2 parity holds in f64 on CPU, while the >500 MDOF/s throughput runs
f32 on the chip.  This script measures BOTH columns for every
analytic-solution driver on identical meshes/configs:

  col A  f64-CPU error vs the analytic/series solution  (the parity claim)
  col B  f32 error vs the same analytic solution        (on-chip regime)
  col C  f32 solution's rel-L2 deviation from the f64 oracle field

plus the ablation case-1 smoke deck (no analytic solution; col C only).
Run the f64 mode first (CPU), then the f32 mode on the GPU:

  python scripts/accuracy_table.py f64     # CPU oracle, /tmp/acc_ref.npz
  python scripts/accuracy_table.py f32     # current platform -> artifact

Writes artifacts_accuracy.json; PARITY.md quotes it.
"""

import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference/myapps/convection_diffusion"
sys.path.insert(0, REPO)

REF_NPZ = os.environ.get("ACC_REF", "/tmp/acc_ref.npz")


def cases(tmp):
    """(name, module, cfg, error_getter, field_key) per driver."""
    return [
        ("linear_cd_2d", "linear_cd_2d",
         {"mesh_file": f"{REF}/Mesh/unit_square.msh", "order": 2},
         lambda o: o["rel_l2"], "u"),
        ("linear_cd_2d_circle", "linear_cd_2d_circle",
         {"mesh_file": f"{REF}/Mesh/unit_circle.msh", "order": 2},
         lambda o: o["rel_l2"], "u"),
        ("linear_cd_transient", "linear_cd_transient",
         {"mesh_file": f"{REF}/Mesh/unit_square.msh", "order": 2,
          "dt": 0.01, "t_final": 0.05},
         lambda o: max(float(o["final_errors"][k]) for k in (3, 5, 7)),
         "c"),
        ("diffusion_mms", "diffusion_mms",
         {"mesh_file": f"{REF}/Mesh/unit_square.msh", "order": 2,
          "alpha": 0.1, "dt": 0.025, "t_final": 0.1},
         lambda o: o["final_l2"], "u"),
        ("diffusion_mms_ale", "diffusion_mms_ale",
         {"mesh_file": f"{REF}/Mesh/unit_square.msh", "order": 1,
          "serial_ref_levels": 1, "alpha": 0.1, "dt": 0.05,
          "t_final": 0.25, "ale_map": "accuracy_b"},
         lambda o: o["final_l2"], "u"),
        ("nonlinear_diffusion", "nonlinear_diffusion",
         {"mesh_file": f"{REF}/Mesh/square_0p01.msh", "order": 2,
          "dt": 0.1, "t_final": 0.3, "L": 0.01, "series_terms": 400,
          "newton_print_level": 0},
         lambda o: float(o["final"][1]), "u"),
    ]


def run_all(mode):
    import importlib

    import numpy as np

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, modname, cfg, err, fkey in cases(tmp):
            mod = importlib.import_module(f"cmfem_tpu.apps.{modname}")
            o = mod.run({**cfg, "save_paraview": False,
                         "output_path": os.path.join(tmp, name)})
            out[name] = {"err_vs_analytic": float(err(o)),
                         "field": np.asarray(o[fkey], np.float64)}

        # ablation case-1 smoke deck: no analytic solution -> field only
        from cmfem_tpu.apps.ablation_case1 import run as run_abl
        from cmfem_tpu.utils.yamlcfg import load_yaml

        cfg = load_yaml(f"{REF}/Input/input_ablation_case1_smoke.yaml")
        cfg.update(output_path=os.path.join(tmp, "abl"),
                   save_paraview=False, newton_print_level=0)
        o = run_abl(cfg)
        out["ablation_case1_smoke"] = {
            "err_vs_analytic": None,
            "field": np.concatenate([np.asarray(o["T"], np.float64),
                                     np.asarray(o["p"], np.float64)])}
    return out


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "f32"
    if mode == "f64":
        os.environ["CMFEM_X64"] = "1"
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        os.environ.setdefault("CMFEM_X64", "0")
    import jax
    import numpy as np

    res = run_all(mode)
    if mode == "f64":
        np.savez(REF_NPZ,
                 **{f"{k}__field": v["field"] for k, v in res.items()},
                 **{f"{k}__err": np.float64(
                     v["err_vs_analytic"]
                     if v["err_vs_analytic"] is not None else np.nan)
                    for k, v in res.items()})
        print(json.dumps({k: v["err_vs_analytic"] for k, v in res.items()}))
        print(f"wrote {REF_NPZ}")
        return 0

    ref = np.load(REF_NPZ)
    table = {"platform_f32": jax.devices()[0].platform}
    for k, v in res.items():
        fr = ref[f"{k}__field"]
        dev = float(np.linalg.norm(v["field"] - fr)
                    / max(np.linalg.norm(fr), 1e-300))
        ea = ref[f"{k}__err"]
        table[k] = {
            "f64_cpu_err_vs_analytic": None if np.isnan(ea) else float(ea),
            "f32_err_vs_analytic": v["err_vs_analytic"],
            "f32_rel_l2_dev_vs_f64_oracle": dev,
        }
    print(json.dumps(table, indent=1))
    with open(os.path.join(REPO, "artifacts_accuracy.json"), "w") as f:
        json.dump(table, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
