"""The Moré-Garbow-Hillstrom problems 1-19, unconstrained or with bounds
(reference: examples/more_garbow_hillstrom.cc)."""

from __future__ import annotations

import numpy as np

import ceres_tpu_torch as ct
from ceres_tpu_torch.examples.more_garbow_hillstrom import PROBLEMS
from ceres_tpu_torch.examples.scripts._cli import parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--constrained", action="store_true", help="with bounds")
    args = ap.parse_args(argv)
    wins = total = 0
    for spec in PROBLEMS:
        if args.constrained and spec.lower_bounds is None:
            continue
        problem, _ = spec.build(constrained=args.constrained)
        summary = ct.solve(ct.SolverOptions(max_num_iterations=300, device=args.device), problem)
        target = spec.constrained_f_min if args.constrained else spec.f_min
        ok = np.isfinite(summary.final_cost) and (
            target is None or summary.final_cost <= target + 1e-4 * (1 + abs(target)))
        wins += bool(ok)
        total += 1
        print(f"{spec.name:28s} final cost {summary.final_cost:.3e} "
              f"(target {target}) {'ok' if ok else 'MISS'}")
    print(f"{wins}/{total} reached the certified minimum")


if __name__ == "__main__":
    main()
