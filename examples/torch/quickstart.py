"""Quickstart on the port: the paper's Listing 2 in five lines.

    PYTHONPATH=src python examples/torch/quickstart.py

The twin of ``examples/quickstart.py`` on ``repro_torch.core`` (it loads
neither ``jax`` nor ``repro``), printing what the reference script prints,
byte for byte; the planner runs on the host and needs no card. The
constraint below uses the composable DSL (core/constraints.py):
``Deadline(s=60)`` ahead of ``MinCost()`` means "meet a 60-second
end-to-end deadline; among configurations that do, spend the least".
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.core import Deadline, Job, Lexicographic, MinCost, \
    Murakkab, VideoInput

# Define the job in natural language (paper Listing 2)
desc = "List objects shown/mentioned in the videos"
# Optional: specify sub-tasks in the job
t1 = "Extract frames from each video"
t2 = "Run speech-to-text on all scenes"
t3 = "Detect objects in the frames"
# Inputs
videos = [VideoInput("cats.mov", scenes=4), VideoInput("formula_1.mov", scenes=4)]

# Execute: meet a 60 s deadline, then minimize spend
system = Murakkab.paper_cluster()
result = Job(description=desc, inputs=videos, tasks=[t1, t2, t3],
             constraints=Lexicographic(Deadline(s=60), MinCost())).execute(system)

print("== task DAG ==")
for row in result.dag.to_json():
    print(f"  {row['id']:<22s} deps={row['deps']}")
print("\n== generated toolcalls (paper §3.2) ==")
for tid, call in result.toolcalls.items():
    print(f"  {tid:<22s} {call}")
print("\n== chosen configuration per task ==")
for tid, cfg in result.plan.configs.items():
    print(f"  {tid:<22s} {cfg.impl:<16s} {cfg.pool:<4s} "
          f"x{cfg.n_devices * cfg.n_instances:<3d} batch={cfg.batch}")
print("\n== execution ==")
print(result.trace_str())
assert result.makespan_s <= 60.0, "deadline missed"
