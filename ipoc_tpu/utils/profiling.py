"""Profiling hooks: jax.profiler traces around solves.

The reference's only tracing is host wall-clock timing (SURVEY §5.1).  These
helpers capture XLA device traces viewable in Perfetto/TensorBoard.
"""

from __future__ import annotations

import contextlib
import os

import jax


@contextlib.contextmanager
def trace(logdir: str = "/tmp/ipoc_trace"):
    """Capture a profiler trace for the enclosed block.

    View with ``tensorboard --logdir <logdir>`` or upload the
    ``.trace.json.gz`` to ui.perfetto.dev.
    """
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span inside a trace (``jax.profiler.TraceAnnotation``)."""
    return jax.profiler.TraceAnnotation(name)
