"""ipoc_tpu — interior-point parallel-in-time optimal control in JAX.

A framework with the capabilities of the reference ``noc`` library
(casiacob/ip-parallel-optimal-control) plus its external ``paroc``
dependency, re-designed for JAX/XLA on NVIDIA GPUs.
"""

import os as _os

import jax as _jax

# On the GPU, float32 matrix products may run in TF32 (about three decimal
# digits) unless asked for full precision.  An interior-point solver chasing
# ||grad||_inf < 1e-4 through chains of thousands of small matrix products
# (costate and Riccati recursions over T stages) cannot afford that, and the
# matrices here are tiny, so full precision costs nothing.  Opt out with
# IPOC_MATMUL_PRECISION=default.
_prec = _os.environ.get("IPOC_MATMUL_PRECISION", "highest")
if _prec != "default":
    _jax.config.update("jax_default_matmul_precision", _prec)

from ipoc_tpu.config import (
    BATCH_CONFIG,
    DEFAULT_CONFIG,
    FAST_CONFIG,
    SolverConfig,
)
from ipoc_tpu.problem import (
    OCP,
    Derivatives,
    LinearizedOCP,
    barrier_ocp,
    log_barrier,
    unconstrained_ocp,
)
from ipoc_tpu.solvers import (
    interior_point_ddp,
    par_interior_point_optimal_control,
    seq_interior_point_optimal_control,
    solve_stream,
)
from ipoc_tpu.parallel import (
    LQT,
    newton_lqt,
    par_bwd_pass,
    par_costates,
    par_fwd_pass,
    seq_bwd_pass,
    seq_costates,
    seq_fwd_pass,
)

__version__ = "0.1.0"
