"""Self-checking ablation-study variant of case 2.2.

Mirrors /root/reference/myapps/convection_diffusion/ablation_test_case2_2_2D_test.cpp
(~1085 changed lines vs the production driver): the same physics with

- per-term ALE toggles (`ale_mass_enabled`, `ale_energy_solid_enabled`,
  `ale_energy_gas_enabled`, :120-123),
- Jacobian-weighted (J_old/J_new per QP) geometric-conservation storage
  terms (`gcl_storage_enabled`, EvaluateQPCoeffs :1678-1775),
- the Amaryllis recession-history loader and in-driver recession error
  metrics (:302-460) written to recession_error_metrics.csv.

Here the production driver is parameterized rather than forked; this entry
point turns the study features on by default and exposes the same config
surface.
"""

from __future__ import annotations

import sys

from .common import parse_args, echo_config
from ..utils.compile_cache import enable_compile_cache
from ..utils.yamlcfg import load_yaml
from .ablation_case2_2 import run as run_case2_2

STUDY_DEFAULTS = {
    "gcl_storage_enabled": True,
    "ale_mass_enabled": True,
    "ale_energy_solid_enabled": True,
    "ale_energy_gas_enabled": True,
    "collection_name": "ablation_test_case2_2_2D_test",
    "output_path": "ParaView/ablation_case2_2_test",
}


def run(cfg: dict) -> dict:
    merged = dict(STUDY_DEFAULTS)
    merged.update(cfg)
    return run_case2_2(merged)


def main(argv=None):
    enable_compile_cache()
    args = parse_args("Input/input_ablation_case2_2.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
