"""Offline analysis of a cohort simulation: time-in-range, hourly risk,
CVGA, the results frame, the figures and the CSVs.

The port's own copy of ``simglucose_tpu/analysis/report.py:22-365``: the
metrics are numpy over a ``[T, B]`` glucose array, and pandas and
matplotlib are imported inside the functions that need them, so importing
this module pulls in neither.  ``cohort_frame`` takes NamedTuples of
arrays or tensors.  Outputs of :func:`report` are the JAX package's:
``performance_stats.csv``, ``risk_trace.csv``, ``CVGA_stats.csv`` and four
figures.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

# Zone thresholds (mg/dL) shared by time-in-range and plot annotations
HYPO = 70.0
HYPER = 180.0
SEVERE_HYPO = 50.0
SEVERE_HYPER = 250.0


# ---------------------------------------------------------------------------
# Array-first metric kernels ([T, B] in, [B]-shaped stats out)
# ---------------------------------------------------------------------------


def time_in_range_stats(bg: np.ndarray) -> dict:
    """Percent-of-time zone statistics per patient.

    ``bg`` is [T, B] (time x patients).  Returns a dict of [B] arrays with
    the reference's five zones (reference: analysis/report.py:74-92).
    """
    bg = np.asarray(bg)
    T = bg.shape[0]
    frac = lambda mask: mask.sum(axis=0) / T * 100.0
    return {
        "70<=BG<=180": frac((bg >= HYPO) & (bg <= HYPER)),
        "BG>180": frac(bg > HYPER),
        "BG<70": frac(bg < HYPO),
        "BG>250": frac(bg > SEVERE_HYPER),
        "BG<50": frac(bg < SEVERE_HYPO),
    }


def hourly_risk(bg: np.ndarray, chunk: int = 60) -> tuple:
    """Hourly LBGI/HBGI/RI from 60-sample chunks of the BG trace.

    Matches the reference's chunked-fBG methodology: the Magni risk transform
    is averaged within each hour FIRST, then squared
    (reference: analysis/report.py:95-110).  Returns (LBGI, HBGI, RI), each
    [H, B] for H whole-or-partial hours.
    """
    bg = np.asarray(bg, np.float64)
    T, B = bg.shape
    n_chunks = (T + chunk - 1) // chunk
    fbg_hour = np.empty((n_chunks, B))
    for h in range(n_chunks):
        seg = bg[h * chunk : (h + 1) * chunk]
        with np.errstate(invalid="ignore", divide="ignore"):
            f = 1.509 * (np.log(np.where(seg > 0, seg, np.nan)) ** 1.084 - 5.381)
        fbg_hour[h] = np.nanmean(f, axis=0)
    lbgi = 10.0 * np.square(fbg_hour * (fbg_hour < 0))
    hbgi = 10.0 * np.square(fbg_hour * (fbg_hour > 0))
    return lbgi, hbgi, lbgi + hbgi


def cvga_points(bg: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-patient CVGA coordinates: (2.5th pct, 97.5th pct) BG clamped to
    [50, 400] (reference: analysis/report.py:199-206)."""
    bg = np.asarray(bg)
    bg_min = np.clip(np.percentile(bg, 2.5, axis=0), 50.0, 400.0)
    bg_max = np.clip(np.percentile(bg, 97.5, axis=0), 50.0, 400.0)
    return bg_min, bg_max


def cvga_zones(bg_min: np.ndarray, bg_max: np.ndarray) -> dict:
    """CVGA zone membership fractions A-E
    (reference zone predicates: analysis/report.py:208-218)."""
    n = float(len(bg_min))
    in_a = (bg_min > 90) & (bg_min <= 110) & (bg_max >= 110) & (bg_max < 180)
    in_ab = (bg_min > 70) & (bg_min <= 110) & (bg_max >= 110) & (bg_max < 300)
    in_c = ((bg_min > 90) & (bg_min <= 110) & (bg_max >= 300)) | (
        (bg_min <= 70) & (bg_max >= 110) & (bg_max < 180)
    )
    in_d = ((bg_min > 70) & (bg_min <= 90) & (bg_max >= 300)) | (
        (bg_min <= 70) & (bg_max >= 180) & (bg_max < 300)
    )
    in_e = (bg_min <= 70) & (bg_max >= 300)
    A = in_a.sum() / n
    return {
        "A": A,
        "B": in_ab.sum() / n - A,
        "C": in_c.sum() / n,
        "D": in_d.sum() / n,
        "E": in_e.sum() / n,
    }


# ---------------------------------------------------------------------------
# Trajectory -> DataFrame adapters
# ---------------------------------------------------------------------------


def trajectory_frame(reset_res, traj, start_time, sample_time: int):
    """One patient's rollout as a reference-style results DataFrame
    (Time-indexed BG/CGM/CHO/insulin/LBGI/HBGI/Risk columns — the schema of
    the reference's per-patient CSVs, simulation/env.py:169-180)."""
    import pandas as pd

    def cat(field):
        head = np.atleast_1d(np.asarray(getattr(reset_res, field)))
        tail = np.asarray(getattr(traj, field))
        return np.concatenate([head, tail])

    n = 1 + np.asarray(traj.BG).shape[0]
    times = pd.date_range(start=start_time, periods=n, freq=f"{sample_time}min")
    df = pd.DataFrame(
        {
            "BG": cat("BG"),
            "CGM": cat("CGM"),
            "CHO": cat("CHO"),
            "insulin": cat("insulin"),
            "LBGI": cat("LBGI"),
            "HBGI": cat("HBGI"),
            "Risk": cat("risk"),
        },
        index=pd.Index(times, name="Time"),
    )
    return df


def cohort_frame(reset_res, traj, patient_names: Sequence[str], start_time, sample_time: int):
    """``[B]`` reset row + ``[T, B]`` trajectory NamedTuples (fields BG, CGM,
    CHO, insulin, LBGI, HBGI, risk) -> the (patient, Time) multi-indexed
    frame that ``report`` consumes."""
    import pandas as pd

    frames = []
    for i in range(len(patient_names)):
        r = type(reset_res)(*(np.asarray(a)[i] for a in reset_res))
        tr = type(traj)(*(np.asarray(a)[:, i] for a in traj))
        frames.append(trajectory_frame(r, tr, start_time, sample_time))
    return pd.concat(frames, keys=patient_names)


def _bg_matrix(df):
    """Multi-index results frame -> (bg [T, B], patient labels)."""
    wide = df.unstack(level=0).BG
    return np.asarray(wide), list(wide.columns), wide


# ---------------------------------------------------------------------------
# Figures
# ---------------------------------------------------------------------------

_CVGA_RECTS = (
    # (x, y, w, h, color, label, white_text)
    (90, 110, 20, 70, "limegreen", "A-Zone", False),
    (70, 110, 20, 70, "green", "Lower B", True),
    (90, 180, 20, 120, "green", "Upper B", True),
    (70, 180, 20, 120, "green", "B-Zone", True),
    (50, 110, 20, 70, "yellow", "Lower C", False),
    (90, 300, 20, 100, "yellow", "Upper C", False),
    (50, 180, 20, 120, "orange", "Lower D", False),
    (70, 300, 20, 100, "orange", "Upper D", False),
    (50, 300, 20, 100, "red", "E-Zone", False),
)


def cvga_figure(bg_min, bg_max, zone_stats: dict, label: str = ""):
    """CVGA scatter on the standard A-E grid
    (grid geometry: reference analysis/report.py:136-195)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1)
    for x, y, w, h, color, name, white in _CVGA_RECTS:
        ax.add_patch(
            plt.Rectangle((x, y), w, h, color=color, ec="w", lw=2, zorder=1)
        )
        ax.annotate(
            name,
            (x + w / 2, y + h / 2),
            weight="bold",
            color="w" if white else "k",
            fontsize=10,
            ha="center",
            va="center",
        )
    pct = {k: int(100 * v) for k, v in zone_stats.items()}
    ax.scatter(
        bg_min,
        bg_max,
        edgecolors="k",
        zorder=4,
        label=(
            f"{label} (A: {pct['A']}%, B: {pct['B']}%, C: {pct['C']}%, "
            f"D: {pct['D']}%, E: {pct['E']}%)"
        ),
    )
    ax.set_xlim(109, 49)
    ax.set_ylim(105, 405)
    ax.set_xticks([110, 90, 70, 50])
    ax.set_yticks([110, 180, 300, 400])
    ax.set_xticklabels(["110", "90", "70", "<50"])
    ax.set_yticklabels(["110", "180", "300", ">400"])
    ax.set_title("Control Variability Grid Analysis (CVGA)")
    ax.set_xlabel("Min BG (2.5th percentile)")
    ax.set_ylabel("Max BG (97.5th percentile)")
    for side in ("top", "right", "bottom", "left"):
        ax.spines[side].set_visible(False)
    ax.legend()
    return fig, ax


def _ensemble_axis(ax, t, values: np.ndarray, ylabel: str, nstd: int = 1):
    """Grey per-patient traces + mean curve + +/-nstd envelope + hypo/hyper
    guide lines (reference: analysis/report.py:14-44)."""
    mean = values.mean(axis=1)
    std = values.std(axis=1, ddof=1) if values.shape[1] > 1 else None
    if std is not None and np.isfinite(std).all():
        ax.fill_between(
            t, mean + nstd * std, mean - nstd * std, alpha=0.5,
            label=f"+/- {nstd}*std",
        )
    ax.plot(t, values, "-", color="grey", alpha=0.5, lw=0.5)
    ax.plot(t, mean, lw=2, label="Mean Curve")
    ax.axhline(HYPO, c="green", linestyle="--", label="Hypoglycemia", lw=1)
    ax.axhline(HYPER, c="red", linestyle="--", label="Hyperglycemia", lw=1)
    ax.set_xlim([t[0], t[-1]])
    ax.set_ylim([values.min() - 10, values.max() + 10])
    ax.set_ylabel(ylabel)
    ax.legend()


def ensemble_figure(df):
    """3-panel ensemble figure: BG, CGM, CHO
    (reference: analysis/report.py:47-71)."""
    import matplotlib.dates as mdates
    import matplotlib.pyplot as plt

    wide_bg = df.unstack(level=0).BG
    wide_cgm = df.unstack(level=0).CGM
    wide_cho = df.unstack(level=0).CHO
    t = wide_bg.index

    fig, (ax1, ax2, ax3) = plt.subplots(3, 1, sharex=True)
    _ensemble_axis(ax1, t, np.asarray(wide_bg), "Blood Glucose (mg/dl)")
    _ensemble_axis(ax2, t, np.asarray(wide_cgm), "CGM (mg/dl)")
    ax3.plot(t, np.asarray(wide_cho))
    ax3.set_ylabel("CHO (g)")
    ax3.xaxis.set_minor_locator(mdates.HourLocator(interval=3))
    ax3.xaxis.set_minor_formatter(mdates.DateFormatter("%H:%M\n"))
    ax3.xaxis.set_major_locator(mdates.DayLocator())
    ax3.xaxis.set_major_formatter(mdates.DateFormatter("\n%b %d"))
    return fig, (ax1, ax2, ax3)


def zone_stats_figure(pstats):
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1)
    pstats.plot(ax=ax, kind="bar")
    ax.set_ylabel("Percent of time in Range (%)")
    fig.tight_layout()
    return fig, ax


def risk_stats_figure(ri_mean):
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1)
    ri_mean.plot(ax=ax, kind="bar")
    fig.tight_layout()
    return fig, ax


# ---------------------------------------------------------------------------
# Top-level report
# ---------------------------------------------------------------------------


def report(df, save_path: Optional[str] = None, show: bool = False):
    """Full offline analysis of a cohort results frame
    (reference: analysis/report.py:246-268).

    ``df`` is a (patient, Time) multi-indexed frame with at least BG/CGM/CHO
    columns (the output of :func:`cohort_frame` or the high-level
    ``simulate``).  Writes performance_stats.csv, risk_trace.csv,
    CVGA_stats.csv and 4 PNG figures when ``save_path`` is given.

    Returns (results, ri_per_hour, zone_stats, figs, axes).
    """
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import pandas as pd

    bg, patients, wide = _bg_matrix(df)

    # stats
    tir = time_in_range_stats(bg)
    pstats = pd.DataFrame(tir, index=pd.Index(patients))
    lbgi, hbgi, ri = hourly_risk(bg)
    H = lbgi.shape[0]
    hour_idx = pd.RangeIndex(H)
    ri_per_hour = pd.concat(
        [
            pd.DataFrame(lbgi.T, index=pd.Index(patients), columns=hour_idx),
            pd.DataFrame(hbgi.T, index=pd.Index(patients), columns=hour_idx),
            pd.DataFrame(ri.T, index=pd.Index(patients), columns=hour_idx),
        ],
        keys=["LBGI", "HBGI", "Risk Index"],
    )
    ri_mean = pd.DataFrame(
        {
            "LBGI": lbgi.mean(axis=0),
            "HBGI": hbgi.mean(axis=0),
            "Risk Index": ri.mean(axis=0),
        },
        index=pd.Index(patients),
    )
    bg_min, bg_max = cvga_points(bg)
    zstats = cvga_zones(bg_min, bg_max)
    zone_stats = pd.DataFrame([zstats])
    results = pd.concat([pstats, ri_mean], axis=1)

    # figures
    fig_ensemble, ens_axes = ensemble_figure(df)
    fig_percent, ax4 = zone_stats_figure(pstats)
    fig_ri, ax5 = risk_stats_figure(ri_mean)
    fig_cvga, ax6 = cvga_figure(bg_min, bg_max, zstats)
    figs = [fig_ensemble, fig_percent, fig_ri, fig_cvga]
    axes = [*ens_axes, ax4, ax5, ax6]

    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
        results.to_csv(os.path.join(save_path, "performance_stats.csv"))
        ri_per_hour.to_csv(os.path.join(save_path, "risk_trace.csv"))
        zone_stats.to_csv(os.path.join(save_path, "CVGA_stats.csv"))
        fig_ensemble.savefig(os.path.join(save_path, "BG_trace.png"))
        fig_percent.savefig(os.path.join(save_path, "zone_stats.png"))
        fig_ri.savefig(os.path.join(save_path, "risk_stats.png"))
        fig_cvga.savefig(os.path.join(save_path, "CVGA.png"))

    if show:  # pragma: no cover
        import matplotlib.pyplot as plt

        plt.show()
    return results, ri_per_hour, zone_stats, figs, axes


# Reference-named aliases for drop-in familiarity
percent_stats = time_in_range_stats
CVGA_analysis = cvga_points
