"""Murakkab core in the port: the paper's contribution as a composable system.

Host code throughout (plans, profiles and the discrete-event engine touch no
device), except ``executor``, which runs a planned DAG with real zoo models
on the card. Public API::

    from repro_torch.core import (Job, Workflow, Tool, MLModel, LLM,
                                  MIN_COST, MIN_ENERGY, MIN_LATENCY,
                                  MAX_QUALITY, Deadline, Budget, Weighted,
                                  Lexicographic, Murakkab, VideoInput,
                                  DocumentInput, QueryInput, RealExecutor)

    system = Murakkab.paper_cluster()
    result = Job("List objects shown/mentioned in the videos",
                 inputs=videos, constraints=MIN_COST).execute(system)
"""
from .admission import (POLICIES, TENANT_CLASSES, Admission, AdmissionPolicy,
                        FCFS, StrictPriority, WeightedFair, get_policy)
from .agents import (AgentImpl, AgentInterface, AgentLibrary, Work,
                     default_library)
from .arrivals import (DEFAULT_TENANT_SHARES, SERVING_PRESETS, ArrivalEvent,
                       ArrivalProcess, MMPPArrivals, PoissonArrivals,
                       ServingPreset, TraceArrivals, default_mix,
                       register_preset)
from .autoscale import Autoscaler, PoolPolicy, ScaleAction
from .cluster import ClusterManager, Instance, Pool
from .constraints import (Budget, Constraint, ConstraintSpec, Deadline,
                          Lexicographic, MaxQuality, MinCost, MinEnergy,
                          MinLatency, Objective, Weighted, as_spec)
from .dag import DAG, TaskNode
from .energy import (CATALOG, DeviceSpec, EnergyLedger, batch_knee,
                     batch_roofline_latency, roofline_latency)
from .executor import (Media, RealExecutor, detect_projections,
                       seeded_sessions)
from .faults import FaultProfile, RetryPolicy
from .orchestrator import LLMPlanner, RulePlanner, dag_creation_overhead
from .profiles import Profile, ProfileStore
from .router import OfflineEvaluator, Router
from .scheduler import ExecutionPlan, Scheduler, TaskConfig
from .telemetry import (QueryFeatures, TaskRecord, TelemetryStore, featurize,
                        featurize_node)
from .simulator import (OpenLoopReport, SimReport, Simulator, Submission,
                        TraceEntry, render_trace)
from .spec import (ARTIFACTS, SCENARIOS, Artifact, ArtifactRegistry,
                   CardinalityModel, InputSet, Scenario, ScenarioRegistry,
                   TaskSpec, TokenModel, build_node, input_artifacts,
                   input_units)
from .system import JobResult, Murakkab
from .workflow import (LLM, MAX_QUALITY, MIN_COST, MIN_ENERGY, MIN_LATENCY,
                       DocumentInput, ImperativeWorkflow, Job, MLModel,
                       QueryInput, Tool, VideoInput, Workflow)

__all__ = [
    "POLICIES", "TENANT_CLASSES", "Admission", "AdmissionPolicy", "FCFS",
    "StrictPriority", "WeightedFair", "get_policy",
    "AgentImpl", "AgentInterface", "AgentLibrary", "Work", "default_library",
    "ClusterManager", "Instance", "Pool", "DAG", "TaskNode",
    "CATALOG", "DeviceSpec", "EnergyLedger", "batch_knee",
    "batch_roofline_latency", "roofline_latency",
    "LLMPlanner", "RulePlanner", "dag_creation_overhead",
    "Profile", "ProfileStore", "ExecutionPlan", "Scheduler", "TaskConfig",
    "OfflineEvaluator", "Router",
    "QueryFeatures", "TaskRecord", "TelemetryStore", "featurize",
    "featurize_node",
    "OpenLoopReport", "SimReport", "Simulator", "Submission", "TraceEntry",
    "render_trace",
    "DEFAULT_TENANT_SHARES", "SERVING_PRESETS", "ArrivalEvent",
    "ArrivalProcess", "MMPPArrivals", "PoissonArrivals", "ServingPreset",
    "TraceArrivals", "default_mix", "register_preset",
    "Autoscaler", "PoolPolicy", "ScaleAction",
    "FaultProfile", "RetryPolicy",
    "JobResult", "Murakkab",
    "Media", "RealExecutor", "detect_projections", "seeded_sessions",
    "ARTIFACTS", "SCENARIOS", "Artifact", "ArtifactRegistry",
    "CardinalityModel", "InputSet", "Scenario", "ScenarioRegistry",
    "TaskSpec", "TokenModel", "build_node", "input_artifacts", "input_units",
    "Budget", "Constraint", "ConstraintSpec", "Deadline", "Lexicographic",
    "MaxQuality", "MinCost", "MinEnergy", "MinLatency", "Objective",
    "Weighted", "as_spec",
    "LLM", "MAX_QUALITY", "MIN_COST", "MIN_ENERGY", "MIN_LATENCY",
    "DocumentInput", "ImperativeWorkflow", "Job", "MLModel", "QueryInput",
    "Tool", "VideoInput", "Workflow",
]
