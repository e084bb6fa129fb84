"""cmfem_tpu — a finite-element framework in JAX.

A clean-room, accelerator-first re-implementation of the capability surface of the
reference suite ``quinnchr-personal/Continuum-Mechanics-MFEM`` (MFEM + PETSc +
MPI application drivers for convection-diffusion and charring-ablator
physics).  Everything is arrays + pure functions: meshes are SoA arrays,
assembly is batched per-element tensor contractions (B^T D B) that XLA
compiles for the device, solvers are jittable Krylov/Newton loops, and multi-chip runs
shard the element batch over a ``jax.sharding.Mesh`` with XLA collectives.

Layout (see SURVEY.md §7 for the blueprint):
  core/      mesh, reference elements, quadrature, H1/L2 spaces, geometry
  ops/       integrators, matrix-free apply, full assembly, essential BCs
  solvers/   CG, GMRES, Chebyshev/Jacobi preconditioners, dense direct, Newton
  physics/   TACOT material, B' table, surface schedules, ablation residuals
  motion/    ALE maps, mesh recession machinery
  parallel/  element partitioning + shard_map operator apply
  io/        GMSH reader, VTU/PVD writer, CSV streams, checkpointing
  apps/      the 11 reference application drivers, re-expressed
"""

import os

import jax

# f64 is required for the 1e-8 relative-L2 parity targets (BASELINE.md).
# Opt out with CMFEM_X64=0 (e.g. for bf16/f32 benchmark runs).
if os.environ.get("CMFEM_X64", "1") == "1":
    jax.config.update("jax_enable_x64", True)

# True-f32 matmuls everywhere: a reduced default matmul precision (TF32 on
# NVIDIA GPUs, bf16 passes elsewhere) keeps ~3 decimal digits, which
# corrupts assembled geometric factors on fine meshes (vertex spacings
# fall below that resolution).  The hot operator paths request HIGHEST
# explicitly; this covers every assembly/geometry einsum by default.  Opt
# out per-call with precision=... for kernels that genuinely tolerate it.
jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
