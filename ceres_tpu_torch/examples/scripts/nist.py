"""The NIST StRD nonlinear regression datasets, scored by certified digits
(reference: examples/nist.cc)."""

from __future__ import annotations

from ceres_tpu_torch.examples.nist import run_nist, summarize_nist
from ceres_tpu_torch.examples.scripts._cli import parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--nist_data_dir", required=True)
    args = ap.parse_args(argv)
    results = run_nist(args.nist_data_dir, device=args.device)
    for name, rs in sorted(results.items()):
        for i, r in enumerate(rs):
            print(f"{name:10s} start {i + 1}: {'SUCCESS' if r.success else 'FAILURE'} "
                  f"lre {r.lre:4.1f} final cost {r.final_cost:.6e} "
                  f"certified {r.certified_cost:.6e}")
    for tier, (wins, total) in summarize_nist(results).items():
        print(f"{tier.capitalize():8s}: {wins}/{total}")


if __name__ == "__main__":
    main()
