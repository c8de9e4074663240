# The paper's routing framework (§III-§IV) on PyTorch tensors: the
# layered-graph model, Algorithm 1 (greedy and lazy greedy), the
# event-driven simulator with both event engines, the committed-work
# ledger and the arrival processes.  Min-plus closures go through the CUDA kernel of
# repro_torch.kernels on the GPU.
from .network import (ComputeNetwork, INF, make_network, small_topology,
                      us_backbone)
from .state import (QueueState, Topology, advance, backlog_seconds,
                    effective_topology, total_backlog)
from .jobs import InferenceJob, JobBatch, batch_jobs, synthetic_job
from . import arrivals
from .routing import (Route, route_single, route_batch,
                      cost_given_assignment, commit_assignment)
from .shortest_path import (Closures, build_closures, build_closures_batch,
                            closure_build_count, reset_closure_build_count)
from .plan import Plan
from .solvers import Solver, solve, register as register_solver, \
    available as available_solvers
from .greedy import greedy_route
from .schedule import SimResult, replay_solution, simulate
from .eventsim import EventEngine
from .completions import (CommittedWork, LedgerJob, drain_exact,
                          exact_backlog_trace, replay_piecewise,
                          run_to_completion)
from . import completions, eventsim, shortest_path, solvers

__all__ = [
    "ComputeNetwork", "INF", "make_network", "small_topology", "us_backbone",
    "Topology", "QueueState", "advance", "backlog_seconds",
    "effective_topology", "total_backlog", "arrivals",
    "InferenceJob", "JobBatch", "batch_jobs", "synthetic_job",
    "Route", "route_single", "route_batch", "cost_given_assignment",
    "commit_assignment",
    "Closures", "build_closures", "build_closures_batch",
    "closure_build_count", "reset_closure_build_count",
    "Plan", "Solver", "solve", "register_solver", "available_solvers",
    "greedy_route",
    "SimResult", "replay_solution", "simulate", "EventEngine",
    "CommittedWork", "LedgerJob", "drain_exact", "exact_backlog_trace",
    "replay_piecewise", "run_to_completion",
    "completions", "eventsim", "shortest_path", "solvers",
]
