"""Sharded Monte-Carlo sweeps and particle-parallel filtering.

The scaling tier (no reference counterpart - the reference is
single-process, SURVEY.md section 2): ``shard_map`` over the mesh's
``rollout`` axis carries independent noise-seeded rollouts (data
parallel; the metric reductions are psums), and the ``particle`` axis
shards one filter's particle cloud across devices (the resampling
collective all-gathers weights - O(N) bytes - so the systematic comb
stays globally exact).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from slamsim.filters.ekf import (EkfConfig, EkfState, ekf_init,
                                 ekf_rollout)
from slamsim.filters.pf import (PfConfig, PfState, pf_estimate,
                                pf_likelihood, resample_indices_from_offs,
                                weights_from_log)
from slamsim.models.process import circular_step
from slamsim.core.se2 import world_to_robot
from slamsim.parallel.mesh import (PARTICLE_AXIS, ROLLOUT_AXIS,
                                   psum_hierarchical)


def sharded_ekf_sweep(cfg: EkfConfig, mesh, keys, n_steps: int,
                      slice_axis: str | None = None):
    """Monte-Carlo EKF sweep sharded over the rollout mesh axis.

    Each device runs its shard of seeded rollouts locally (vmap over the
    local batch); position-RMSE is reduced with ``psum`` so every device
    holds the global scalar.  Rollout ``i`` uses ``keys[i]`` wherever it
    runs, so its trajectory is the one-device trajectory.

    Args:
        keys: ``(B,)`` PRNG keys, B divisible by the sharded axis sizes.
        slice_axis: name of an outer mesh axis over groups of devices
            (:data:`slamsim.parallel.mesh.SLICE_AXIS`).  Rollouts then
            shard over ``slice x rollout`` and the RMSE reduction is
            hierarchical: within a group first, one combined value per
            group across groups after.

    Returns:
        ``(x_true, x_pre, rmse)``: sharded ``(B, T, 3)`` trajectory
        buffers and the replicated global RMSE scalar.
    """
    axes = (ROLLOUT_AXIS,) if slice_axis is None else (
        slice_axis, ROLLOUT_AXIS)

    def reduce_sum(v):
        return psum_hierarchical(v, ROLLOUT_AXIS, slice_axis)

    def local(keys_shard):
        # Mark the (constant-initialized) filter state as varying over the
        # sharded axes so the scan carry types check under shard_map.
        state0 = jax.tree.map(
            lambda x: jax.lax.pcast(x, axes, to="varying"),
            ekf_init(cfg, (keys_shard.shape[0],)))
        _, outs = jax.vmap(
            lambda k, s: ekf_rollout(cfg, k, n_steps, state0=s))(
                keys_shard, state0)
        err = outs.x_pre[..., :2] - outs.x_true[..., :2]
        se = reduce_sum(jnp.sum(err * err))
        n = reduce_sum(
            jnp.asarray(err.shape[0] * err.shape[1], err.dtype))
        rmse = jnp.sqrt(se / n)
        return outs.x_true, outs.x_pre, rmse

    fn = jax.shard_map(local, mesh=mesh, in_specs=P(axes),
                       out_specs=(P(axes), P(axes), P()))
    return fn(keys)


def sharded_ekf_fused_sweep(cfg: EkfConfig, mesh, seed, batch: int,
                            n_steps: int, noise_on: bool = True,
                            interpret: bool = False,
                            slice_axis: str | None = None):
    """Fused-kernel Monte-Carlo EKF sweep sharded over ``rollout``.

    Every device runs the whole-rollout kernel
    (:func:`slamsim.ops.ekf_fused_rollout`) on its slice of the batch -
    one launch per device for all ``n_steps`` - and the squared-error
    sums reduce to the global RMSE with one ``psum``.  Each device passes
    the global index of its first rollout to the kernel, which keys the
    noise by global rollout index: the sweep draws the same noise, and
    gives the same per-rollout results, as one call over the whole batch
    on one device.

    Args:
        batch: total rollouts, divisible by the number of devices.

    Returns:
        ``(final, err, rmse)``: the sharded final :class:`EkfState`
        (leading axis ``batch``), per-rollout summed squared position
        error of the prior estimate ``(batch,)``, and the replicated
        global position RMSE.
    """
    from slamsim.ops import ekf_fused_rollout

    axes = (ROLLOUT_AXIS,) if slice_axis is None else (
        slice_axis, ROLLOUT_AXIS)
    n_dev = 1
    for a in axes:
        n_dev *= mesh.shape[a]
    if batch % n_dev:
        raise ValueError(f"batch {batch} not divisible by {n_dev}")
    b_local = batch // n_dev

    def local(seed_arr):
        my = jax.lax.axis_index(ROLLOUT_AXIS)
        if slice_axis is not None:
            my = my + jax.lax.axis_index(slice_axis) * mesh.shape[
                ROLLOUT_AXIS]
        final, err = ekf_fused_rollout(
            cfg, seed_arr[0], batch=b_local, n_steps=n_steps,
            noise_on=noise_on, interpret=interpret,
            first_index=my * b_local)
        se = psum_hierarchical(jnp.sum(err), ROLLOUT_AXIS, slice_axis)
        rmse = jnp.sqrt(se / (batch * n_steps))
        return final, err, rmse

    fn = jax.shard_map(
        local, mesh=mesh, in_specs=P(),
        out_specs=(jax.tree.map(lambda _: P(axes),
                                EkfState(0, 0, 0, 0)),
                   P(axes), P()),
        check_vma=False)
    return fn(jnp.asarray([seed], jnp.int32))


def sharded_pf_step(cfg: PfConfig, mesh, state: PfState, key):
    """One PF step with the particle cloud sharded over ``particle``.

    The predict and likelihood stages are embarrassingly parallel per
    particle shard; weight normalization is a ``psum``; ESS-gated
    systematic resampling all-gathers ``(weights, particles)`` so the
    global comb walk (particle_filter.py:212-221 semantics) is exact, then
    each device keeps its slice of the resampled cloud.  Noise and comb
    are :func:`slamsim.filters.pf.pf_step`'s own draws, so from the same
    state and key the step matches ``pf_step`` up to the order in which
    the weight sums are taken.

    Args:
        state: ``PfState`` whose ``particles``/``weights`` leading axis is
            sharded over the particle mesh axis.

    Returns:
        ``(next_state, x_est)`` with the same shardings.
    """
    n_total = cfg.num_particles

    def local(x_true, particles, weights, key):
        k_rs, k_pred, k_obs = jax.random.split(key, 3)
        my = jax.lax.axis_index(PARTICLE_AXIS)
        n_local = particles.shape[0]

        def my_slice(x):
            return jax.lax.dynamic_slice_in_dim(x, my * n_local, n_local)

        # ESS gate on global weights.
        ess = 1.0 / jax.lax.psum(jnp.sum(weights * weights), PARTICLE_AXIS)
        do_rs = ess < n_total * cfg.ess_threshold_frac

        def resample(args):
            particles, weights = args
            all_w = jax.lax.all_gather(weights, PARTICLE_AXIS,
                                       tiled=True)  # (N,)
            all_p = jax.lax.all_gather(particles, PARTICLE_AXIS,
                                       tiled=True)  # (N, 3)
            # pf_step's own comb on the gathered weights: the same
            # selection as one device makes.
            offs = jax.random.uniform(k_rs, dtype=weights.dtype)
            idx = resample_indices_from_offs(offs, all_w,
                                             cfg.resample_method)
            return all_p[my_slice(idx)], jnp.full_like(weights,
                                                       1.0 / n_total)

        particles, weights = jax.lax.cond(
            do_rs, resample, lambda a: a, (particles, weights))

        # Predict (local), with this shard's part of pf_step's draw.
        q = my_slice(jax.random.normal(k_pred, (n_total, 3),
                                       particles.dtype))
        particles = circular_step(particles, cfg.vel, cfg.yaw_rate,
                                  cfg.dt) + q * jnp.asarray(cfg.q_std)

        # Truth + observation (replicated math, same key everywhere).
        x_true_next = circular_step(x_true, cfg.vel, cfg.yaw_rate, cfg.dt)
        lm = jnp.asarray(cfg.landmarks)
        z = world_to_robot(x_true_next, lm)
        z = z + jax.random.normal(k_obs, z.shape,
                                  z.dtype) * jnp.asarray(cfg.r_std)

        # Weight (local) + global normalize.
        like = pf_likelihood(cfg, particles, z)
        if cfg.weight_mode == "log":
            lw = jnp.log(weights) + like
            m = jax.lax.pmax(jnp.max(lw), PARTICLE_AXIS)
            lse = m + jnp.log(jax.lax.psum(jnp.sum(jnp.exp(lw - m)),
                                           PARTICLE_AXIS))
            w = weights_from_log(cfg, lw, lse)
        else:
            w = weights * like
            w = w / jax.lax.psum(jnp.sum(w), PARTICLE_AXIS)
            w = jnp.where(jnp.isnan(w), 1.0 / n_total, w)

        # Global MAP estimate: argmax across devices.
        local_max = jnp.max(w)
        all_max = jax.lax.all_gather(local_max, PARTICLE_AXIS)
        best_dev = jnp.argmax(all_max)
        cand = pf_estimate(cfg, particles, w)  # local argmax particle
        all_cand = jax.lax.all_gather(cand, PARTICLE_AXIS)
        x_est = all_cand[best_dev]
        return x_true_next, particles, w, x_est

    # check_vma=False: x_true / x_est are value-replicated (they come from
    # all_gather / identical per-device math) but the static analysis
    # cannot prove it.
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(PARTICLE_AXIS), P(PARTICLE_AXIS), P()),
        out_specs=(P(), P(PARTICLE_AXIS), P(PARTICLE_AXIS), P()),
        check_vma=False)
    x_true, particles, weights, x_est = fn(state.x_true, state.particles,
                                           state.weights, key)
    return PfState(x_true=x_true, particles=particles,
                   weights=weights), x_est
