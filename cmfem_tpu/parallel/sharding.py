"""Multi-chip operator apply: elements sharded over a device mesh.

The replacement for the reference's MPI domain decomposition
(``ParMesh`` + true-dof halo exchange, SURVEY.md §2.4): the element batch is
the data-parallel axis.  Each device owns a contiguous slab of elements and
the full (replicated) DOF vector; an operator apply is

    gather (local) -> batched B^T D B kernel (local) -> segment_sum (local)
    -> psum over the mesh axis  (XLA all-reduce riding ICI)

which is exactly T^T A T with the shared-DOF exchange expressed as one
collective.  Reductions (norms, dot products) are free: vectors are
replicated, so plain jnp reductions are device-local and identical.

For very large meshes the dof-partitioned variant in
``parallel.dofpart`` (owned-slab vectors + interface-psum halo exchange)
reduces per-device memory ∝ 1/N; the replicated-vector scheme here
matches the problem sizes of the reference suite and keeps CG/GMRES
unchanged.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_device_mesh(n_devices: int | None = None, axis: str = "dd") -> Mesh:
    """Build a 1-axis device mesh over the first ``n_devices`` devices.

    Raises if fewer than ``n_devices`` devices exist: an N-way run that
    silently degrades to fewer devices is a false green (a sharded
    correctness claim would then be vacuous).
    """
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"make_device_mesh: requested {n_devices} devices but only "
                f"{len(devs)} exist ({devs[0].platform}); provision a "
                "virtual CPU mesh (jax_num_cpu_devices / "
                "xla_force_host_platform_device_count) before backend init."
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_elements(mesh: Mesh, *arrays, axis: str = "dd"):
    """Pad the leading (element) axis to a multiple of the mesh size and
    shard it.  Padding is ZERO-FILLED for every array — pad elements map
    all their dofs to global dof 0, which is only safe because callers
    pass zero-padded operator data (their pad contributions are exactly
    zero).  Callers that pad with real data must duplicate element 0 and
    zero the weights instead (see ShardedAblationNewton.pad_elem).
    Returns (padded sharded arrays, ne_pad)."""
    n = mesh.devices.size
    outs = []
    ne = arrays[0].shape[0]
    ne_pad = ((ne + n - 1) // n) * n
    pad = ne_pad - ne
    sharding = NamedSharding(mesh, P(axis))
    for a in arrays:
        a = np.asarray(a)
        if pad:
            pad_block = np.zeros((pad,) + a.shape[1:], dtype=a.dtype)
            a = np.concatenate([a, pad_block], axis=0)
        outs.append(jax.device_put(a, sharding))
    return outs, ne_pad


def qp_block_apply(B, G, u_e, d00, d01, d10, d11):
    """Element-local B^T D B quadrature apply: u_e (nel, nd) -> y_e
    (nel, nd) through whichever of the four QP data blocks are present
    (None = absent).  Shared by every element-sharded operator body
    (ShardedPoissonApply, DofPartitionedOperator) so layout fixes land
    once."""
    uq = jnp.einsum("qn,en->eq", B, u_e)
    gq = jnp.einsum("qnr,en->eqr", G, u_e)
    bq = None
    if d00 is not None:
        bq = d00 * uq
    if d01 is not None:
        t = jnp.sum(d01 * gq, axis=-1)
        bq = t if bq is None else bq + t
    fq = None
    if d10 is not None:
        fq = d10 * uq[..., None]
    if d11 is not None:
        t = jnp.sum(d11 * gq[..., None, :], axis=-1)
        fq = t if fq is None else fq + t
    y_e = 0.0
    if bq is not None:
        y_e = jnp.einsum("qn,eq->en", B, bq)
    if fq is not None:
        y_e = y_e + jnp.einsum("qnr,eqr->en", G, fq)
    return y_e


class ShardedPoissonApply:
    """Element-sharded matrix-free apply of a (mass+)diffusion operator.

    Holds element-sharded eldofs and QP operator data; `apply` is jittable
    and returns the replicated global product.  Padding elements carry
    zeroed operator data so they contribute nothing.
    """

    def __init__(self, ops, data, mesh: Mesh, axis: str = "dd"):
        self.ops = ops
        self.mesh = mesh
        self.axis = axis
        self.nscalar = ops.fes.nscalar
        eldofs = np.asarray(ops.fes.element_dofs)
        blocks = []
        self._have = {}
        for name in ("d00", "d01", "d10", "d11"):
            v = getattr(data, name)
            self._have[name] = v is not None
            if v is not None:
                blocks.append(np.asarray(v))
        (self.eldofs, *sharded_blocks), self.ne_pad = shard_elements(
            mesh, eldofs, *blocks, axis=axis
        )
        it = iter(sharded_blocks)
        self.d00 = next(it) if self._have["d00"] else None
        self.d01 = next(it) if self._have["d01"] else None
        self.d10 = next(it) if self._have["d10"] else None
        self.d11 = next(it) if self._have["d11"] else None
        self.B = jnp.asarray(ops.B)
        self.G = jnp.asarray(ops.G)

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(axis), P()) + tuple(P(axis) for _ in sharded_blocks),
            out_specs=P(),
        )
        def _apply(eldofs, u, *blocks):
            it = iter(blocks)
            d00 = next(it) if self._have["d00"] else None
            d01 = next(it) if self._have["d01"] else None
            d10 = next(it) if self._have["d10"] else None
            d11 = next(it) if self._have["d11"] else None
            y_e = qp_block_apply(self.B, self.G, u[eldofs],
                                 d00, d01, d10, d11)
            y = jax.ops.segment_sum(
                y_e.reshape(-1), eldofs.reshape(-1), num_segments=self.nscalar
            )
            return jax.lax.psum(y, self.axis)

        self._apply = _apply

    def __call__(self, u):
        blocks = [b for b in (self.d00, self.d01, self.d10, self.d11)
                  if b is not None]
        return self._apply(self.eldofs, u, *blocks)
