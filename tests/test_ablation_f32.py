"""f32 ablation Newton parity vs the f64 oracle.

The flagship coupled (T, p) physics must also run in pure f32, the fast
precision of an accelerator.  The enabling pieces
are (a) symmetric diagonal equilibration + the 2x2 point-block PC, which
collapse the system's ~1e9 conditioning spread to ~2e5 (f32-solvable), and
(b) the Givens-rotation GMRES in ``solvers.krylov`` whose progressive QR
never feeds post-breakdown noise columns into the triangular solve (a
terminal f32 lstsq over all restart columns produced garbage directions).

The subprocess pair exists because x64 is a process-global JAX switch: the
32 run is executed with CMFEM_X64=0 exactly as an f32 device run would be.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

HELPER = str(Path(__file__).with_name("f32newton_helper.py"))


@pytest.fixture(scope="module")
def f32_f64_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("f32newton")
    files = {}
    for mode in ("64", "32"):
        path = out / f"run{mode}.npz"
        r = subprocess.run([sys.executable, HELPER, mode, str(path)],
                           capture_output=True, text=True, timeout=900)
        assert r.returncode == 0, r.stderr[-2000:]
        files[mode] = np.load(path)
    return files


def test_f32_newton_converges_and_matches_f64(f32_f64_runs):
    d32, d64 = f32_f64_runs["32"], f32_f64_runs["64"]
    h32, h64 = d32["hist"], d64["hist"]
    # f64 oracle converges hard; f32 must reach its cancellation floor:
    # >= 1e-3 relative residual reduction on this problem (measured
    # plateau ~1.2e-3 of |R0|).  The floor is judged on the BEST iterate
    # (what the production stall-exit keeps): undamped f32 iterates
    # oscillate within noise of the floor and the final entry may sit a
    # few x above the minimum
    assert h64.min() < 1e-4 * h64[0]
    assert h32.min() < 2e-3 * h32[0], h32
    # the tail stays bounded near the floor (noise, not divergence)
    assert h32[-1] < 10.0 * max(h32.min(), 1e-30), h32
    assert np.all(np.isfinite(h32))
    # converged fields match the f64 oracle to f32-roundoff levels
    for k, tol in (("T", 1e-5), ("p", 1e-5)):
        num = np.abs(d32[k] - d64[k]).max()
        den = np.abs(d64[k]).max()
        assert num / den < tol, (k, num / den)


def test_block_gmres_f32_factors_are_finite():
    """In-process f32 sanity of the equilibration path: dtype-aware tiny
    guards (1e-300 flushes to zero in f32) must keep the factors finite."""
    import jax.numpy as jnp

    from cmfem_tpu.solvers.blocksolve import equilibrated_block_factors

    ne, nd, n = 4, 4, 8
    rng = np.random.default_rng(0)
    ed = rng.integers(0, n, (ne, nd))
    Je = jnp.asarray(rng.standard_normal((ne, 2 * nd, 2 * nd)),
                     jnp.float32)
    # blow up the T/p scale disparity like the real system
    Je = Je.at[:, nd:, nd:].multiply(1e-7)
    Je = Je.at[:, :nd, :nd].multiply(1e2)
    lmask = jnp.zeros((ne, 2 * nd), bool)
    mask2 = jnp.zeros(2 * n, bool)
    eldofs = jnp.asarray(ed)

    def gather(x):
        return jnp.concatenate([x[:n][eldofs], x[n:][eldofs]], axis=1)

    def scatter(y_e):
        import jax

        flat = eldofs.reshape(-1)
        yT = jax.ops.segment_sum(y_e[:, :nd].reshape(-1), flat,
                                 num_segments=n)
        yp = jax.ops.segment_sum(y_e[:, nd:].reshape(-1), flat,
                                 num_segments=n)
        return jnp.concatenate([yT, yp])

    Je_s, pb, s = equilibrated_block_factors(Je, lmask, mask2, gather,
                                             scatter, nd, n)
    assert Je_s.dtype == jnp.float32
    for a in (Je_s, pb, s):
        assert np.isfinite(np.asarray(a)).all()
