"""One rank of a sharded ceres_tpu_torch run on the CPU (gloo), for the
multi-process tests (test_torch_sharding.py, test_torch_multiprocess.py).

It imports torch and ceres_tpu_torch only. The parent starts one process
per rank, each under a timeout:

    python tests/torch_mp_worker.py <rank> <world> <port> <spec.json> <out_dir>

spec.json: {"mesh": "global" | "hybrid", "local_size": k, "threshold": t,
"cases": [...], "bal_path": path or null, "backend": "gloo" (default) or
"nccl", "device": "cpu" (default) or "cuda:0"}. The rank joins the process
group over tcp://localhost:<port>, runs every case of the spec in order
on its shard and writes out_dir/rank<rank>.pkl: per case the numbers the
parent compares (evaluation outputs, or per-iteration solve summaries),
and under "replicate" what parallel.distributed.replicate gave the rank.

A spec {"script": [name, arg, ...]} runs instead one example program of
ceres_tpu_torch/examples/scripts as torchrun would start it (its
environment: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and
writes what it printed, {"stdout": text}.
"""

import json
import logging
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (options, enum values by name; problem seed); the parent runs the same cases on
# ceres_tpu's sharded solve and on the port's unsharded one. "bounds" puts
# lower bounds on the problem (`constrain`)
SOLVE_CASES = {
    "ischur_schur_jacobi": ({"linear_solver_type": "ITERATIVE_SCHUR",
                             "preconditioner_type": "SCHUR_JACOBI"}, 3),
    "cgnr_jacobi": ({"linear_solver_type": "CGNR", "preconditioner_type": "JACOBI"}, 3),
    "dogleg": ({"linear_solver_type": "ITERATIVE_SCHUR", "preconditioner_type": "JACOBI",
                "trust_region_strategy_type": "DOGLEG"}, 3),
    "cluster_jacobi": ({"linear_solver_type": "ITERATIVE_SCHUR",
                        "preconditioner_type": "CLUSTER_JACOBI"}, 3),
    "subset": ({"linear_solver_type": "CGNR", "preconditioner_type": "SUBSET"}, 3),
    "cluster_tridiagonal": ({"linear_solver_type": "ITERATIVE_SCHUR",
                             "preconditioner_type": "CLUSTER_TRIDIAGONAL"}, 3),
    "line_search": ({"minimizer_type": "LINE_SEARCH"}, 3),
    "mixed_precision": ({"linear_solver_type": "ITERATIVE_SCHUR",
                         "preconditioner_type": "SCHUR_JACOBI",
                         "use_mixed_precision_solves": True}, 3),
    "dense_schur": ({"linear_solver_type": "DENSE_SCHUR"}, 3),
    "bounds": ({"linear_solver_type": "ITERATIVE_SCHUR", "preconditioner_type": "SCHUR_JACOBI",
                "bounds": True}, 3),
}
# cases ceres_tpu cannot run on a mesh (its inner iterations raise NameError
# "unbound axis name" there): held to the port's unsharded solve only
PORT_ONLY_CASES = {
    "inner_iterations": ({"linear_solver_type": "ITERATIVE_SCHUR",
                          "preconditioner_type": "SCHUR_JACOBI", "use_inner_iterations": True}, 3),
}
SOLVE_ITERATIONS = 5
# (problem seed, observations) of the evaluation cases, as tests/test_sharding.py
EVAL_CASE = (2, 203)
_ENUMS = {"linear_solver_type": "LinearSolverType", "preconditioner_type": "PreconditionerType",
          "trust_region_strategy_type": "TrustRegionStrategyType",
          "minimizer_type": "MinimizerType"}


def case_spec(case):
    return {**SOLVE_CASES, **PORT_ONLY_CASES}[case]


def solve_options(ct_or_jax, case, **extra):
    """SolverOptions of a SOLVE_CASES entry for either package (its module)."""
    opts, _seed = case_spec(case)
    kw = {}
    for name, value in opts.items():
        if name in _ENUMS:
            kw[name] = getattr(getattr(ct_or_jax, _ENUMS[name]), value)
        elif name != "bounds":
            kw[name] = value
    return ct_or_jax.SolverOptions(max_num_iterations=SOLVE_ITERATIONS, **kw, **extra)


def constrain(problem, points, case):
    """The bounds of a case: the depth coordinate of the first 10 points at
    least -1 (for either package's Problem; binding on the seed-3 problem)."""
    if case_spec(case)[0].get("bounds"):
        for h in list(points)[:10]:
            problem.set_parameter_lower_bound(h, 2, -1.0)
    return problem


def summary_record(s):
    """The per-iteration numbers of a Summary (for the parity and lockstep
    checks)."""
    its = s.iterations
    return {
        "cost": [it.cost for it in its],
        "gradient_max_norm": [it.gradient_max_norm for it in its],
        "gradient_norm": [it.gradient_norm for it in its],
        "radius": [it.trust_region_radius for it in its],
        "step_norm": [it.step_norm for it in its],
        "relative_decrease": [it.relative_decrease for it in its],
        "linear_solver_iterations": [it.linear_solver_iterations for it in its],
        "step_is_successful": [it.step_is_successful for it in its],
        # the port's count (ceres_tpu's summaries have none)
        "num_device_reads": [getattr(it, "num_device_reads", None) for it in its],
        "initial_cost": s.initial_cost,
        "final_cost": s.final_cost,
        "used_fused_execution": s.used_fused_execution,
    }


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def run_eval(ct, mesh):
    """Cost, gradient, JᵀJ v, column norms and Plus on the rank's shard."""
    import numpy as np
    import torch

    from ceres_tpu_torch.parallel.sharding import ShardedEvaluator

    seed, n_obs = EVAL_CASE
    program = ct.build_ba_problem(ct.synthetic_bal(6, 50, n_obs, seed=seed))[0].compile("cpu")
    ev = ShardedEvaluator(program, mesh, dtype=torch.float64)
    state = program.state_vector(torch.float64)
    cost, res, jac, grad = ev.evaluate_groups(state)
    v = torch.as_tensor(np.random.default_rng(0).normal(0, 1, program.num_effective_parameters))
    delta = torch.as_tensor(
        np.random.default_rng(1).normal(0, 0.01, program.num_effective_parameters))
    garr = ev.arrays["groups"][0]
    return {
        "cost": float(cost), "gradient": grad.numpy(), "jtj": jac.jtj_multiply(v).numpy(),
        "column_norms": jac.squared_column_norms().numpy(),
        "plus": ev.plus(state, delta).numpy(),
        "pad_lanes": int((garr["mask"] == 0).sum()), "lanes": int(garr["mask"].numel()),
        "plans": {pos: plan[0] for pos, plan in garr["plans"].items()},
    }


def solve_problem(ct, case, bal=None):
    """The Huber BA problem of a SOLVE_CASES entry (or of `bal`)."""
    if bal is None:
        bal = ct.synthetic_bal(6, 50, 203, seed=case_spec(case)[1])
    problem, _, points = ct.build_ba_problem(bal, loss=ct.HuberLoss(1.0))
    return constrain(problem, points, case)


def run_solve(ct, mesh, case, bal=None):
    import torch

    problem = solve_problem(ct, case, bal)
    handler = _Warnings()
    logging.getLogger("ceres_tpu_torch").addHandler(handler)
    try:
        s = ct.solve(solve_options(ct, case, mesh=mesh, dtype=torch.float64), problem)
    finally:
        logging.getLogger("ceres_tpu_torch").removeHandler(handler)
    out = summary_record(s)
    out["warnings"] = handler.messages
    return out


def run_script(argv, rank, world, port):
    """Run an example program's main(argv[1:]) as rank `rank` of a torchrun
    group; returns what it printed."""
    import contextlib
    import importlib
    import io

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    mod = importlib.import_module(f"ceres_tpu_torch.examples.scripts.{argv[0]}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(argv[1:])
    return {"stdout": out.getvalue()}


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    spec = json.load(open(sys.argv[4]))
    import torch

    torch.set_num_threads(1)
    if spec.get("script"):
        out = run_script(spec["script"], rank, world, port)
        with open(os.path.join(sys.argv[5], f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        return
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.parallel import distributed
    from ceres_tpu_torch.program import Program
    from ceres_tpu_torch.utils.execution_summary import counts, reset_counts

    Program.SEG_REDUCE_THRESHOLD = spec["threshold"]
    distributed.initialize(spec.get("backend", "gloo"), f"tcp://localhost:{port}", world, rank,
                           spec.get("device", "cpu"), timeout_seconds=120)
    if spec["mesh"] == "hybrid":
        mesh = distributed.hybrid_mesh(local_size=spec["local_size"])
    else:
        mesh = distributed.global_mesh()
    bal = ct.load_bal_lazy(spec["bal_path"]) if spec.get("bal_path") else None
    # every rank offers its own value; replicate hands each rank 0's
    out = {"replicate": distributed.replicate([rank, 1.5, 2.5], mesh).tolist()}
    for case in spec["cases"]:
        reset_counts()
        out[case] = run_eval(ct, mesh) if case == "eval" else run_solve(ct, mesh, case, bal)
        out[case]["all_reduces"] = counts()["Mesh::AllReduce"]
    with open(os.path.join(sys.argv[5], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
