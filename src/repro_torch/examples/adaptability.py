"""Fig.-14 style adaptability demo, the counterpart of the reference's
``examples/adaptability.py``: steer the accuracy/cost trade-off with alpha
and beta across all five paper pipelines, each decision by ``solve_enum``
(the torch enumeration, on the card unless ``--device`` says otherwise).

  PYTHONPATH=src python -m repro_torch.examples.adaptability
  PYTHONPATH=src python -m repro_torch.examples.adaptability --device cpu
"""
import argparse

from repro_torch.core import optimizer as OPT
from repro_torch.core import paper_profiles as PP


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    lam = 15.0
    print(f"{'pipeline':12s} {'preference':16s} {'PAS':>7s} {'cost':>6s}")
    for pname, fn in PP.PIPELINES.items():
        pipe = fn()
        for alpha, beta, tag in ((0.2, 2.0, "resource-prior"),
                                 (2.0, 1.0, "balanced"),
                                 (50.0, 0.2, "accuracy-prior")):
            sol = OPT.solve_enum(pipe, lam,
                                 OPT.Objective(alpha=alpha, beta=beta),
                                 device=args.device)
            if sol.feasible:
                print(f"{pname:12s} {tag:16s} {sol.pas:7.2f} {sol.cost:6.0f}")
            else:
                print(f"{pname:12s} {tag:16s} infeasible at lambda={lam}")


if __name__ == "__main__":
    main()
