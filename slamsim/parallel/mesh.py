"""Device meshes for rollout/particle parallelism.

The reference is single-process with no distributed components
(SURVEY.md section 2, parallelism table); this module is the new
framework's scaling tier: a 1-D (or 2-D) ``jax.sharding.Mesh`` whose
``rollout`` axis carries Monte-Carlo rollouts (data parallel) and whose
optional ``particle`` axis shards particle clouds.  The mesh follows the
algorithm alone: the GPUs of one host reach each other all to all at
one rate, so a mesh is a plain reshape of the device list.  The same
code runs on a virtual N-device CPU mesh in CI
(``jax.config.update('jax_num_cpu_devices', N)``, SURVEY.md section 4.4)
and on the GPUs unmodified.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROLLOUT_AXIS = "rollout"
PARTICLE_AXIS = "particle"
#: Outer mesh axis over groups of devices (hosts) joined by links slower
#: than those inside a group, so reductions are HIERARCHICAL - combine
#: within a group first, then send one group-combined value across
#: groups (:func:`psum_hierarchical`).  Shard only throughput axes
#: (rollouts, edge sets) over it; never halo-exchange or per-step state.
SLICE_AXIS = "slice"


def make_mesh(n_rollout: int | None = None, n_particle: int = 1,
              devices=None) -> Mesh:
    """Build a mesh over the available devices.

    Args:
        n_rollout: size of the rollout axis (default: all devices /
            ``n_particle``).
        n_particle: size of the particle axis (default 1 -> 1-D mesh).
        devices: explicit device list (default ``jax.devices()``).

    Returns:
        A ``Mesh`` with axes ``(rollout,)`` or ``(rollout, particle)``.
    """
    if devices is None:
        devices = jax.devices()
    if n_rollout is None:
        n_rollout = len(devices) // n_particle
    devs = np.asarray(devices[:n_rollout * n_particle])
    if n_particle == 1:
        return Mesh(devs.reshape(n_rollout), (ROLLOUT_AXIS,))
    return Mesh(devs.reshape(n_rollout, n_particle),
                (ROLLOUT_AXIS, PARTICLE_AXIS))


def rollout_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding that splits a leading batch axis over the rollout axis."""
    return NamedSharding(mesh, P(ROLLOUT_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize multi-process JAX (one process per host).

    On a multi-host deployment every host calls this FIRST - before any
    ``jax.devices()`` / array op touches the backend
    (``jax.distributed.initialize`` refuses to run afterwards); then
    ``jax.devices()`` spans all hosts and :func:`make_multislice_mesh`
    lays the outer axis over them.  Arguments default to
    ``jax.distributed.initialize``'s own auto-detection (Slurm, the
    standard env vars); an environment without any such configuration
    (CI, one host, the CPU mesh) is a no-op.

    Returns True iff distributed mode is (now) active.
    """
    if jax.distributed.is_initialized():
        return jax.process_count() > 1
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except (RuntimeError, ValueError):
        # No coordinator configured / nothing to auto-detect (the
        # single-process case), or the backend was already initialized
        # by earlier device use - either way: not distributed.
        return False
    return jax.process_count() > 1


def make_multislice_mesh(n_slice: int, n_per_slice: int | None = None,
                         devices=None, inner_axis: str = ROLLOUT_AXIS
                         ) -> Mesh:
    """Build a 2-D ``(slice, inner)`` mesh over groups of devices.

    The outer ``slice`` axis spans the groups (hosts), the inner axis the
    devices of one group; the device order must list each group's
    devices contiguously, as ``jax.devices()`` does across hosts.
    """
    if devices is None:
        devices = jax.devices()
    if n_per_slice is None:
        n_per_slice = len(devices) // n_slice
    want = n_slice * n_per_slice
    if len(devices) < want:
        raise ValueError(f"need {want} devices, have {len(devices)}")
    devs = np.asarray(devices[:want]).reshape(n_slice, n_per_slice)
    return Mesh(devs, (SLICE_AXIS, inner_axis))


def psum_hierarchical(x, inner_axis: str = ROLLOUT_AXIS,
                      outer_axis: str | None = SLICE_AXIS):
    """Two-stage psum: combine within a group, then across groups.

    Semantically equal to ``psum(x, (inner, outer))`` but the staging
    moves only one group-combined value per group over the slow links
    instead of flat-reducing every device's contribution across them.

    ``outer_axis=None`` (one group) skips the second stage, so callers
    with an optional slice axis reduce through one code path.
    """
    x = jax.lax.psum(x, inner_axis)
    if outer_axis is not None:
        x = jax.lax.psum(x, outer_axis)
    return x
