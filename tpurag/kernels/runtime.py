"""Kernel runtime helpers: the platform dispatch point, tiling math, padding."""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Plain Python float so kernels treat it as an inline literal (a numpy/jax
# scalar would be lifted into kernel constants).
NEG_INF = -3.0e38


def platform() -> str:
    """The platform JAX computes on, by JAX's own name ('gpu', 'cpu', ...).

    The one place the program asks which machine it runs on: kernel
    wrappers pass this to their routing functions, which compare it only
    against JAX's platform names."""
    return jax.default_backend()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length() if x > 1 else 1


def pad_axis(x: jax.Array, axis: int, size: int, value=0) -> jax.Array:
    """Pad `axis` of x up to `size` with `value` (no-op if already there)."""
    cur = x.shape[axis]
    if cur == size:
        return x
    if cur > size:
        raise ValueError(f"cannot pad axis {axis} from {cur} down to {size}")
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, size - cur)
    return jnp.pad(x, widths, constant_values=value)
