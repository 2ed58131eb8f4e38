"""Bundle adjustment of a BAL problem, or a small synthetic one (reference:
examples/simple_bundle_adjuster.cc)."""

from __future__ import annotations

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.scripts._cli import parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--input", help="BAL problem file (synthetic if omitted)")
    args = ap.parse_args(argv)
    bal = ct.load_bal(args.input) if args.input else ct.synthetic_bal(8, 128, 512, seed=0)
    bal.normalize()
    problem, _, _ = ct.build_ba_problem(bal)
    options = ct.SolverOptions(linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
                               max_num_iterations=50, minimizer_progress_to_stdout=True,
                               device=args.device)
    summary = ct.solve(options, problem)
    print(summary.full_report())


if __name__ == "__main__":
    main()
