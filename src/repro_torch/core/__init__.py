"""The workflow side of the port: the real executor of ``repro.core``.

Only ``executor`` is ported. The planner, scheduler and agent library are
framework-free; the executor duck-types the DAG, plan and library objects
its caller built and keeps no copy of them.
"""
from .executor import Media, RealExecutor, detect_projections, seeded_sessions

__all__ = ["Media", "RealExecutor", "detect_projections", "seeded_sessions"]
