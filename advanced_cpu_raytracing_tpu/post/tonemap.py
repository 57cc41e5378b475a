"""Reinhard photographic tonemapping (Tonemapper, src/tonemapper.h:28-121).

Two passes expressed as jit-friendly reductions:
  1. statistics — log-average luminance (delta = 0.01, Rec.709 weights) and
     the burn percentile taken over the *sorted flat channel values* (the
     reference sorts all W*H*3 channel samples, tonemapper.h:33-52);
  2. per-pixel mapping — Reinhard with optional L_white burnout, saturation
     exponent on channel ratios, inverse-gamma encode, floor to 8-bit.

``reinhard_tonemap_sharded`` (below) runs the same two passes on a pixel
batch sharded across a device mesh: the log-mean lowers to a psum and the percentile's global sort to an XLA-inserted all-gather + sort (the
statistic is over the full W*H*3 sample set, so cross-shard data movement is
inherent; 12 B/pixel of gather is negligible next to the render itself).
Padded lanes are excluded from both statistics via the ``mask`` argument.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from advanced_cpu_raytracing_tpu.utils.math3d import luminance


@partial(jax.jit, static_argnames=("key_value", "burn_percent", "saturation",
                                   "gamma"))
def reinhard_tonemap_device(hdr, key_value: float = 0.18,
                            burn_percent: float = 1.0,
                            saturation: float = 1.0, gamma: float = 2.2):
    """hdr: (H,W,3) float -> (H,W,3) uint8."""
    delta = 0.01
    lum = luminance(hdr)
    avg_lum = jnp.exp(jnp.mean(jnp.log(delta + lum.astype(jnp.float64))))
    avg_lum = avg_lum.astype(jnp.float32)

    l_scaled = key_value * lum / avg_lum

    if burn_percent > 0.01:
        flat = jnp.sort(hdr.reshape(-1))
        last = flat.shape[0] - 1
        idx = min(int((100.0 - burn_percent) / 100.0 * last), last)
        thresh = flat[idx] * key_value / avg_lum
        lw2 = thresh * thresh
        y_o = (l_scaled * (1.0 + l_scaled / lw2)) / (1.0 + l_scaled)
    else:
        y_o = l_scaled / (1.0 + l_scaled)

    lum_safe = jnp.where(lum == 0, 1e-20, lum)
    ratios = hdr / lum_safe[..., None]
    rgb = jnp.clip(y_o[..., None] * jnp.power(jnp.maximum(ratios, 0.0),
                                              saturation), 0.0, 1.0)
    enc = jnp.floor(jnp.minimum(255.0, 255.0 * jnp.power(rgb, 1.0 / gamma)))
    return enc.astype(jnp.uint8)


def reinhard_tonemap(hdr: np.ndarray, key_value: float = 0.18,
                     burn_percent: float = 1.0, saturation: float = 1.0,
                     gamma: float = 2.2) -> np.ndarray:
    return np.asarray(
        reinhard_tonemap_device(
            jnp.asarray(np.nan_to_num(hdr, nan=0.0)), key_value=key_value,
            burn_percent=burn_percent, saturation=saturation, gamma=gamma,
        )
    )


@partial(jax.jit, static_argnames=("key_value", "burn_percent", "saturation",
                                   "gamma"))
def _tonemap_flat(hdr, mask, key_value: float, burn_percent: float,
                  saturation: float, gamma: float):
    """Mask-aware tonemap over a flat (N,3) batch — the SPMD body for the
    sharded path.  ``mask`` (N,) excludes padded lanes from the log-mean and
    the burn percentile; masked lanes produce garbage output (callers drop
    them)."""
    delta = 0.01
    lum = luminance(hdr)
    n_valid = jnp.maximum(jnp.sum(mask), 1.0)
    avg_lum = jnp.exp(
        jnp.sum(jnp.log(delta + lum.astype(jnp.float64)) * mask) / n_valid
    ).astype(jnp.float32)

    l_scaled = key_value * lum / avg_lum

    if burn_percent > 0.01:
        # padded channel samples sort to the top and are skipped by indexing
        # with the valid count (reference sorts all W*H*3 channel values,
        # tonemapper.h:36-52)
        flat = jnp.sort(jnp.where(mask[:, None] > 0, hdr, jnp.inf).reshape(-1))
        last = 3.0 * n_valid - 1.0
        idx = jnp.clip(((100.0 - burn_percent) / 100.0 * last), 0.0,
                       last).astype(jnp.int32)
        thresh = flat[idx] * key_value / avg_lum
        lw2 = thresh * thresh
        y_o = (l_scaled * (1.0 + l_scaled / lw2)) / (1.0 + l_scaled)
    else:
        y_o = l_scaled / (1.0 + l_scaled)

    lum_safe = jnp.where(lum == 0, 1e-20, lum)
    ratios = hdr / lum_safe[..., None]
    rgb = jnp.clip(y_o[..., None] * jnp.power(jnp.maximum(ratios, 0.0),
                                              saturation), 0.0, 1.0)
    enc = jnp.floor(jnp.minimum(255.0, 255.0 * jnp.power(rgb, 1.0 / gamma)))
    return enc.astype(jnp.uint8)


def reinhard_tonemap_sharded(hdr, mesh, key_value: float = 0.18,
                             burn_percent: float = 1.0,
                             saturation: float = 1.0,
                             gamma: float = 2.2) -> np.ndarray:
    """Two-pass Reinhard over an (H,W,3) image with pixels sharded across
    ``mesh``'s devices.  The log-mean reduction lowers to a psum;
    the percentile's global sort to an all-gather + sort (see module
    docstring).  Bit-identical to the single-device path up to fp reduction
    order."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    h, w, _ = hdr.shape
    total = h * w
    n_dev = mesh.size
    pad = (-total) % n_dev
    flat = np.nan_to_num(np.asarray(hdr, np.float32), nan=0.0).reshape(-1, 3)
    flat = np.pad(flat, ((0, pad), (0, 0)))
    mask = np.zeros(total + pad, np.float32)
    mask[:total] = 1.0

    shard = NamedSharding(mesh, P(mesh.axis_names[0]))
    flat_d = jax.device_put(jnp.asarray(flat), shard)
    mask_d = jax.device_put(jnp.asarray(mask), shard)
    out = _tonemap_flat(flat_d, mask_d, key_value, burn_percent, saturation,
                        gamma)
    return np.asarray(out)[:total].reshape(h, w, 3)
