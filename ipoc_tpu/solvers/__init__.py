from ipoc_tpu.solvers.barrier import barrier_loop
from ipoc_tpu.solvers.globalization import gain_ratio, lm_update
from ipoc_tpu.solvers.ip_ddp import ddp_bwd_pass, interior_point_ddp
from ipoc_tpu.solvers.ip_newton import (
    par_interior_point_optimal_control,
    par_newton_step,
    seq_bwd_newton,
    seq_fwd_newton,
    seq_interior_point_optimal_control,
)
from ipoc_tpu.solvers.stream import (
    MultigridSolution,
    StreamSolution,
    solve_stream,
    solve_stream_multigrid,
    solve_stream_multigrid_sharded,
    solve_stream_sharded,
)
from ipoc_tpu.solvers.time_sharded import (
    ip_newton_batch_time_sharded,
    ip_newton_time_sharded,
)
