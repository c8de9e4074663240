# The paper's routing framework (§III-§IV) on PyTorch tensors: the
# layered-graph model, Algorithm 1 (greedy and lazy greedy) and the
# event-driven simulator.  Min-plus closures go through the CUDA kernel of
# repro_torch.kernels on the GPU.
from .network import (ComputeNetwork, INF, make_network, small_topology,
                      us_backbone)
from .state import (QueueState, Topology, advance, backlog_seconds,
                    effective_topology, total_backlog)
from .jobs import InferenceJob, JobBatch, batch_jobs, synthetic_job
from .routing import (Route, route_single, route_batch,
                      cost_given_assignment, commit_assignment)
from .shortest_path import (Closures, build_closures, build_closures_batch,
                            closure_build_count, reset_closure_build_count)
from .plan import Plan
from .solvers import Solver, solve, register as register_solver, \
    available as available_solvers
from .greedy import greedy_route
from .schedule import SimResult, replay_solution, simulate
from . import shortest_path, solvers

__all__ = [
    "ComputeNetwork", "INF", "make_network", "small_topology", "us_backbone",
    "Topology", "QueueState", "advance", "backlog_seconds",
    "effective_topology", "total_backlog",
    "InferenceJob", "JobBatch", "batch_jobs", "synthetic_job",
    "Route", "route_single", "route_batch", "cost_given_assignment",
    "commit_assignment",
    "Closures", "build_closures", "build_closures_batch",
    "closure_build_count", "reset_closure_build_count",
    "Plan", "Solver", "solve", "register_solver", "available_solvers",
    "greedy_route",
    "SimResult", "replay_solution", "simulate",
    "shortest_path", "solvers",
]
