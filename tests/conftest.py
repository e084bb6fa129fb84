"""Test config: the CPU backend with an 8-device virtual mesh, and f64.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``; the platform is also
pinned below, so that on a machine with a GPU it still runs on the CPU).  The
multi-device tests use the 8 virtual CPU devices.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("CMFEM_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# persistent compile cache: the suite is compile-dominated
from cmfem_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import pytest  # noqa: E402


REFERENCE_DIR = "/root/reference/myapps/convection_diffusion"


@pytest.fixture(scope="session")
def reference_dir():
    return REFERENCE_DIR
