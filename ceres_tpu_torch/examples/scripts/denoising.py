"""Image denoising under a Fields-of-Experts prior (reference:
examples/denoising.cc)."""

from __future__ import annotations

import numpy as np

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.denoising import (
    build_foe_denoising_problem,
    load_foe_file,
    load_pgm,
    save_pgm,
)
from ceres_tpu_torch.examples.scripts._cli import parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--input", required=True, help="noisy PGM image")
    ap.add_argument("--foe_file", required=True, help="trained FoE prior")
    ap.add_argument("--output", help="output PGM")
    ap.add_argument("--sigma", type=float, default=20.0)
    ap.add_argument("--num_iterations", type=int, default=10)
    args = ap.parse_args(argv)
    img = load_pgm(args.input)
    problem, px = build_foe_denoising_problem(img, load_foe_file(args.foe_file), sigma=args.sigma)
    options = ct.SolverOptions(linear_solver_type=ct.LinearSolverType.CGNR,
                               max_num_iterations=args.num_iterations,
                               minimizer_progress_to_stdout=True, device=args.device)
    summary = ct.solve(options, problem)
    print(summary.brief_report())
    if args.output:
        out = np.array([problem.parameter_block_value(i)[0] for i in px]).reshape(img.shape)
        save_pgm(args.output, out)


if __name__ == "__main__":
    main()
