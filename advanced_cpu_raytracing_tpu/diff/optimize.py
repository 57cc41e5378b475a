"""Gradient-based scene-parameter optimization (inverse rendering).

Optimize material/light parameters so the rendered image matches a target,
via Adam over the differentiable wavefront renderer.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax

from advanced_cpu_raytracing_tpu.diff.params import extract_params, inject_params
from advanced_cpu_raytracing_tpu.render.integrator import (
    RenderOptions,
    trace_radiance,
)


def make_loss(cam, px, py, opts: RenderOptions, target):
    def loss_fn(params, pack, key):
        pack = inject_params(pack, params)
        img = trace_radiance(pack, cam, px, py, key, opts)
        return jnp.mean((img - target) ** 2)

    return loss_fn


def optimize(pack, cam, px, py, opts: RenderOptions, target, fields,
             steps: int = 50, lr: float = 5e-2, seed: int = 0):
    """Returns (optimized pack, loss history).  Parameters are traced
    leaves of the pack, so every step reuses one executable."""
    params = extract_params(pack, fields)
    loss_fn = make_loss(cam, px, py, opts, jnp.asarray(target))
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    @partial(jax.jit, donate_argnums=())
    def step(params, opt_state, pack, key):
        loss, grads = jax.value_and_grad(loss_fn)(params, pack, key)
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    key = jax.random.PRNGKey(seed)
    history = []
    for i in range(steps):
        key, sub = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, pack, sub)
        history.append(float(loss))
    return inject_params(pack, params), history
