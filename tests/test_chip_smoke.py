"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal to run
anywhere but a GPU."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def test_apply_phase_small():
    out = cs.phase_apply(cases=((2, 3), (3, 2)), reps=1)
    for rec in out:
        assert rec["best"] == "periodic"
        for p in rec["paths"].values():
            assert p["err"] <= 1e-5 and p["t_apply_s"] > 0
    assert set(out[0]["paths"]) == {"plain", "periodic"}


def test_solve_phase_small():
    (rec,) = cs.phase_solve(cases=((2, 4),))
    assert rec["converged"] and rec["true_rel_residual"] <= 2e-6
    assert rec["iters"] < 20


def test_driver_phase_matches_jacobi_runs(tmp_path):
    """The MG-preconditioned driver runs reproduce the L2 errors of the
    same configs solved with the Jacobi preconditioner."""
    from cmfem_tpu.apps import diffusion_mms, linear_cd_2d

    small = dict(base_n=8, ref_levels=1, order=3, steps=3)
    mesh = str(tmp_path / "ref.msh")
    cs.write_unit_square_msh(mesh, small["base_n"])
    cfgs = cs.driver_configs(mesh, str(tmp_path / "jacobi"),
                             small["ref_levels"], small["order"],
                             small["steps"])
    pinned = {
        "diffusion_mms": diffusion_mms.run(
            {**cfgs["diffusion_mms"], "linear_solver": "jacobi"})["final_l2"],
        "linear_cd_2d": linear_cd_2d.run(
            {**cfgs["linear_cd_2d"], "linear_solver": "jacobi"})["abs_l2"],
    }
    out = cs.phase_driver(str(tmp_path / "mg"), pinned=pinned, **small)
    assert out["diffusion_mms"]["ndofs"] == (3 * 16 + 1) ** 2
    for rec in out.values():
        assert rec["rel_vs_pinned"] <= 1e-6


def test_four_cards_phase_on_virtual_devices():
    out = cs.phase_four_cards(n=4, order=2)
    assert out["element_sharded_cg_rel"] <= 1e-6
    assert out["dof_partitioned_cg_rel"] <= 1e-6
    assert out["sumfact_sharded_apply_rel"] <= 1e-6


def test_refuses_to_run_without_a_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "needs a GPU" in p.stderr


def test_unit_square_msh_reads_back(tmp_path):
    from cmfem_tpu.core import load_gmsh

    path = str(tmp_path / "sq.msh")
    cs.write_unit_square_msh(path, 3)
    for native in (True, False):
        m = load_gmsh(path, use_native=native)
        assert m.geom == "triangle" and m.num_elements == 18
        lo, hi = m.bounding_box()
        np.testing.assert_array_equal(lo, [0.0, 0.0])
        np.testing.assert_array_equal(hi, [1.0, 1.0])
        assert sorted(set(m.bdr_attr.tolist())) == [1, 2, 3, 4]
        assert m.num_bdr_faces == 12
