"""Bundle adjustment driver over BAL datasets (reference:
examples/bundle_adjuster.cc; flag surface at bundle_adjuster.cu.cc:74-145).

    python -m ceres_tpu_torch.examples.scripts.bundle_adjuster \\
        --input problem-16-22106-pre.txt --linear_solver iterative_schur \\
        --preconditioner schur_jacobi --num_iterations 20
    python -m ceres_tpu_torch.examples.scripts.bundle_adjuster --synthetic 16,2210,8000
    torchrun --nproc-per-node=2 -m ceres_tpu_torch.examples.scripts.bundle_adjuster \
        --synthetic 16,2210,8000 --num_devices 2

Prints the solver's full report, like Solver::Summary::FullReport().
"""

from __future__ import annotations

import os

import numpy as np
import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.scripts._cli import parser


def _args(argv):
    ap = parser(__doc__)
    ap.add_argument("--input", help="BAL problem file")
    ap.add_argument("--synthetic",
                    help="generate a synthetic BAL problem: num_cameras,num_points,num_obs")
    ap.add_argument("--linear_solver", default="iterative_schur", choices=[
        "dense_qr", "dense_normal_cholesky", "sparse_normal_cholesky", "dense_schur",
        "sparse_schur", "iterative_schur", "cgnr"])
    ap.add_argument("--preconditioner", default="schur_jacobi", choices=[
        "identity", "jacobi", "schur_jacobi", "schur_power_series_expansion",
        "cluster_jacobi", "cluster_tridiagonal"])
    ap.add_argument("--visibility_clustering", default="canonical_views",
                    choices=["canonical_views", "single_linkage"])
    ap.add_argument("--trust_region_strategy", default="levenberg_marquardt",
                    choices=["levenberg_marquardt", "dogleg"])
    ap.add_argument("--dogleg", default="traditional_dogleg",
                    choices=["traditional_dogleg", "subspace_dogleg"])
    ap.add_argument("--num_iterations", type=int, default=20)
    ap.add_argument("--max_linear_solver_iterations", type=int, default=500)
    ap.add_argument("--max_solver_time", type=float, default=1e32)
    ap.add_argument("--eta", type=float, default=1e-1)
    ap.add_argument("--robustify", action="store_true", help="use Huber loss")
    ap.add_argument("--inner_iterations", action="store_true")
    ap.add_argument("--nonmonotonic_steps", action="store_true")
    ap.add_argument("--line_search", action="store_true",
                    help="line-search minimizer instead of trust region")
    ap.add_argument("--use_quaternions", action="store_true",
                    help="quaternion camera rotations (10-param camera blocks)")
    ap.add_argument("--use_manifolds", action="store_true",
                    help="with --use_quaternions: Quaternion x Euclidean(6) manifold")
    ap.add_argument("--linear_solver_ordering", default="automatic",
                    choices=["automatic", "points", "cameras"],
                    help="which blocks Schur solvers eliminate (automatic: independent set)")
    ap.add_argument("--explicit_schur_complement", action="store_true",
                    help="ITERATIVE_SCHUR: materialize S; PCG on the dense reduced matrix")
    ap.add_argument("--use_spse_initialization", action="store_true",
                    help="power-series init of the ITERATIVE_SCHUR solution")
    ap.add_argument("--spse_tolerance", type=float, default=0.1)
    ap.add_argument("--max_num_spse_iterations", type=int, default=5)
    ap.add_argument("--inner_iteration_ordering", default="automatic",
                    choices=["automatic", "points", "cameras"],
                    help="blocks the inner-iteration minimizer refines")
    ap.add_argument("--inner_iteration_tolerance", type=float, default=1e-3)
    ap.add_argument("--trust_region_line_search", action="store_true",
                    help="Armijo polish on every valid TR step (unbounded problems)")
    ap.add_argument("--fused_chunk_iters", type=int, default=0,
                    help="LM iterations per fused device dispatch (0 = default)")
    ap.add_argument("--mixed_precision", action="store_true", help="float32 path")
    ap.add_argument("--mixed_precision_solves", action="store_true",
                    help="bfloat16 PCG matvecs")
    ap.add_argument("--max_num_refinement_iterations", type=int, default=3)
    ap.add_argument("--rotation_sigma", type=float, default=0.0)
    ap.add_argument("--translation_sigma", type=float, default=0.0)
    ap.add_argument("--point_sigma", type=float, default=0.0)
    ap.add_argument("--random_seed", type=int, default=38401)
    ap.add_argument("--num_devices", type=int, default=1,
                    help="mesh size: more than 1 shards the solve over that many ranks, "
                         "one process each, started by torchrun")
    ap.add_argument("--initial_ply", help="write initial reconstruction PLY")
    ap.add_argument("--final_ply", help="write final reconstruction PLY")
    args = ap.parse_args(argv)
    if not (args.input or args.synthetic):
        ap.error("provide --input or --synthetic")
    return args


def _mesh(args):
    """The mesh of a sharded run (examples/bundle_adjuster.py:190-194): this
    process joins torchrun's group (parallel.distributed.initialize) and
    spans every rank. None for --num_devices 1."""
    if args.num_devices <= 1:
        return None
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != args.num_devices:
        raise ValueError(
            f"--num_devices {args.num_devices} needs as many ranks, one process each "
            f"(torchrun --nproc-per-node={args.num_devices}); this run has {world}")
    from ceres_tpu_torch.parallel import distributed

    distributed.initialize(device=args.device)
    return distributed.global_mesh()


def main(argv=None):
    args = _args(argv)
    mesh = _mesh(args)
    if args.input:
        bal = ct.load_bal(args.input)
    else:
        nc, np_, no = (int(x) for x in args.synthetic.split(","))
        bal = ct.synthetic_bal(nc, np_, no, seed=1)
    print(f"problem: {bal.num_cameras} cameras, {bal.num_points} points, "
          f"{bal.num_observations} observations")
    bal.normalize()
    if args.rotation_sigma or args.translation_sigma or args.point_sigma:
        bal.perturb(rotation_sigma=args.rotation_sigma, translation_sigma=args.translation_sigma,
                    point_sigma=args.point_sigma, seed=args.random_seed)
    if args.initial_ply:
        bal.write_ply(args.initial_ply)
    problem, cams, pts = ct.build_ba_problem(
        bal, loss=ct.HuberLoss(1.0) if args.robustify else None,
        use_quaternions=args.use_quaternions, use_manifolds=args.use_manifolds)

    def ordering(which):
        if which == "automatic":
            return None
        return [int(h) for h in (pts if which == "points" else cams)]

    options = ct.SolverOptions(
        minimizer_type=(ct.MinimizerType.LINE_SEARCH if args.line_search
                        else ct.MinimizerType.TRUST_REGION),
        trust_region_strategy_type=ct.TrustRegionStrategyType[args.trust_region_strategy.upper()],
        dogleg_type=ct.DoglegType[args.dogleg.upper()],
        linear_solver_type=ct.LinearSolverType[args.linear_solver.upper()],
        preconditioner_type=ct.PreconditionerType[args.preconditioner.upper()],
        visibility_clustering_type=ct.VisibilityClusteringType[args.visibility_clustering.upper()],
        max_num_iterations=args.num_iterations,
        max_linear_solver_iterations=args.max_linear_solver_iterations,
        max_solver_time_in_seconds=args.max_solver_time,
        eta=args.eta,
        use_inner_iterations=args.inner_iterations,
        use_nonmonotonic_steps=args.nonmonotonic_steps,
        use_explicit_schur_complement=args.explicit_schur_complement,
        linear_solver_ordering=ordering(args.linear_solver_ordering),
        use_spse_initialization=args.use_spse_initialization,
        spse_tolerance=args.spse_tolerance,
        max_num_spse_iterations=args.max_num_spse_iterations,
        inner_iteration_tolerance=args.inner_iteration_tolerance,
        inner_iteration_ordering=ordering(args.inner_iteration_ordering),
        trust_region_use_line_search=args.trust_region_line_search,
        fused_execution_chunk_iters=args.fused_chunk_iters,
        use_mixed_precision_solves=args.mixed_precision_solves,
        max_num_refinement_iterations=args.max_num_refinement_iterations,
        minimizer_progress_to_stdout=True,
        dtype=torch.float32 if args.mixed_precision else torch.float64,
        device=args.device,
        mesh=mesh,
    )
    summary = ct.solve(options, problem)
    print()
    print(summary.full_report())
    if args.final_ply:
        bal.cameras = np.stack([problem.parameter_block_value(c) for c in cams])
        bal.points = np.stack([problem.parameter_block_value(p) for p in pts])
        bal.write_ply(args.final_ply)
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
