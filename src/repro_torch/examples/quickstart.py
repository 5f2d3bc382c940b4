"""Quickstart: IPA on the paper's video pipeline in ~a minute, the
counterpart of the reference's ``examples/quickstart.py``.

Builds the two-stage video pipeline (YOLO family -> ResNet family) from the
paper's appendix profiles, solves the Eq.-10 Integer Program at a few loads,
and runs the full online adaptation loop against a bursty Twitter-style
trace, comparing IPA with the FA2/RIM baselines.  numpy only: it runs on the
CPU.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from repro_torch.core import adapter as AD
from repro_torch.core import baselines as BL
from repro_torch.core import optimizer as OPT
from repro_torch.core import paper_profiles as PP
from repro_torch.core import trace as TR


def main(argv=None) -> None:
    pipe = PP.video()
    print(f"pipeline: {pipe.name}   SLA_P = {pipe.sla:.2f}s")
    for st in pipe.stages:
        print(f"  stage {st.name}: "
              + ", ".join(f"{v.name}(acc={v.accuracy}, R={v.base_alloc})"
                          for v in st.variants))

    obj = OPT.Objective(**PP.PAPER_WEIGHTS["video"], metric="pas")
    print("\n-- one-shot decisions (Eq. 10) --")
    for lam in (5.0, 20.0, 40.0):
        sol = BL.ipa(pipe, lam, obj=obj)
        cfg = [(s.variant, s.batch, s.replicas) for s in sol.config.stages]
        print(f"lambda={lam:5.1f} rps -> {cfg}  PAS={sol.pas:.1f} "
              f"cost={sol.cost:.0f} cores  ({sol.solve_time*1e3:.0f} ms)")

    print("\n-- online adaptation on a bursty trace (Figs. 8-12) --")
    rates = TR.excerpt("bursty", seconds=180)
    for pol in ("ipa", "fa2_low", "fa2_high", "rim"):
        res = AD.run_trace(pipe, rates, policy=pol, obj=obj, seed=0)
        s = res.summary()
        print(f"{pol:9s} PAS={s['mean_pas']:6.2f} cost={s['mean_cost']:6.1f} "
              f"viol={s['sla_violation_rate']:.3f} drops={s['dropped']}")


if __name__ == "__main__":
    main()
