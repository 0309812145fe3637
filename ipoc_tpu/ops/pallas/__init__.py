"""Hand-written GPU kernels and the rule that picks them.

One kernel family lives here: the fused lane iteration
(fused_iter_kernel.py), two Pallas launches through Triton that evaluate a
whole Newton trial per scenario.  It is chosen by observable properties
only — backend, dtype and state dimension — and everything else runs the
plain XLA composition it is tested against.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Largest state dimension the fused kernel unrolls: its value-function
# carry holds nx * nx lane vectors in registers.
MAX_NX = 8


def use_fused_lane_iter(dtype, nx: int) -> bool:
    """The fused lane iteration runs on the GPU backend, in float32, for
    nx <= MAX_NX.  CPU runs and float64 take the XLA composition."""
    return (jax.default_backend() == "gpu" and dtype == jnp.float32
            and nx <= MAX_NX)
