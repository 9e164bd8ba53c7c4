"""Re-analyze saved results CSVs offline; no simulation needed.

Counterpart of ``examples/offline_analysis.py`` (capability parity:
reference examples/offline_analysis.py:1-16).  By default it reads the
canned fixture of the examples (``examples/results/canned``, a 5-patient x
24 h BB cohort run); point ``result_dir`` at any ``simulate(save_path=...)``
output to re-analyze your own runs.  The JAX script writes the report into
``result_dir``; here the report goes to ``save_path`` (default: none
written), so the committed fixture stays as it is.  Run with ``python -m
simglucose_tpu_torch.examples.offline_analysis [result_dir [save_path]]``;
needs pandas and matplotlib.
"""
import glob
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CANNED = os.path.join(ROOT, "examples", "results", "canned")


def main(result_dir: str = CANNED, save_path=None):
    """Returns the per-patient performance statistics frame."""
    import pandas as pd

    from simglucose_tpu_torch.analysis.report import report

    csvs = sorted(glob.glob(os.path.join(result_dir, "*#*.csv")))
    if not csvs:
        raise SystemExit(
            f"no per-patient CSVs under {result_dir}; pass a simulate("
            "save_path=...) output directory or run the advanced_tutorial example"
        )
    names = [os.path.splitext(os.path.basename(f))[0] for f in csvs]
    df = pd.concat(
        [pd.read_csv(f, index_col="Time", parse_dates=True) for f in csvs],
        keys=names,
    )
    results, ri_per_hour, zone_stats, figs, axes = report(df, save_path=save_path)
    print(results)
    return results


if __name__ == "__main__":
    main(*sys.argv[1:3])
