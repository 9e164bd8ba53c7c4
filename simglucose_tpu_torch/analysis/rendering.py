"""Live simulation viewer: 4-panel interactive matplotlib animation.

Counterpart of ``simglucose_tpu/analysis/rendering.py:15-143``, the same
code: BG+CGM with glycemic-zone shading, CHO, insulin, and LBGI/HBGI/RI
risk traces, redrawn incrementally from the accumulated results DataFrame
with the reference renderer's axis-window law (reference:
simulation/rendering.py:9-167).  matplotlib is imported inside the
functions that draw (the card's machine has none).
"""
from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


def _adjust_ylim(ax, ymin, ymax):
    """Incremental y-window expansion (the reference Viewer's explicit
    axis management, reference: rendering.py:119-136): grow the window by
    a 10% margin only when data exceeds it — never shrink, so the view
    stays steady during live animation."""
    y1, y2 = ax.get_ylim()
    update = False
    if ymin < y1:
        y1 = ymin - 0.1 * abs(ymin)
        update = True
    if ymax > y2:
        y2 = ymax + 0.1 * abs(ymax)
        update = True
    if update:
        ax.set_ylim([y1, y2])


def _adjust_xlim(ax, tmax):
    """Expand the time window by 6-hour blocks whenever the newest sample
    comes within 30 minutes of the right edge (reference:
    rendering.py:138-167)."""
    from datetime import timedelta

    import matplotlib.dates as mdates

    x0, x1 = mdates.num2date(ax.get_xlim())
    tmax = tmax.replace(tzinfo=None)
    x0 = x0.replace(tzinfo=None)
    x1 = x1.replace(tzinfo=None)
    if tmax > x1 - timedelta(minutes=30):
        ax.set_xlim([x0, x1 + timedelta(hours=6)])


class Viewer:
    def __init__(self, start_time, patient_name, figsize=None):
        self.start_time = start_time
        self.patient_name = patient_name
        self.fig = None
        self._lines = None

    def _initialize(self):
        import matplotlib.pyplot as plt

        plt.ion()
        self.fig, self.axes = plt.subplots(
            4, 1, sharex=True, figsize=(9, 10)
        )
        ax_bg, ax_cho, ax_ins, ax_risk = self.axes
        # glycemic zone shading (reference: rendering.py:46-50)
        ax_bg.axhspan(70, 180, alpha=0.3, color="limegreen", lw=0)
        ax_bg.axhspan(50, 70, alpha=0.3, color="red", lw=0)
        ax_bg.axhspan(0, 50, alpha=0.3, color="darkred", lw=0)
        ax_bg.axhspan(180, 250, alpha=0.3, color="orange", lw=0)
        ax_bg.axhspan(250, 1000, alpha=0.3, color="darkorange", lw=0)
        ax_bg.set_ylim(40, 400)

        (self._l_bg,) = ax_bg.plot([], [], label="BG (mg/dL)")
        (self._l_cgm,) = ax_bg.plot([], [], label="CGM (mg/dL)")
        (self._l_cho,) = ax_cho.plot([], [], label="CHO (g/min)")
        (self._l_ins,) = ax_ins.plot([], [], label="insulin (U/min)")
        (self._l_lbgi,) = ax_risk.plot([], [], label="LBGI")
        (self._l_hbgi,) = ax_risk.plot([], [], label="HBGI")
        (self._l_ri,) = ax_risk.plot([], [], label="Risk Index")

        ax_bg.set_ylabel("BG (mg/dL)")
        ax_cho.set_ylabel("CHO (g/min)")
        ax_ins.set_ylabel("insulin (U/min)")
        ax_risk.set_ylabel("Risk Index")
        # initial time window; render() extends it in 6 h blocks
        from datetime import timedelta

        ax_risk.set_xlim(
            [self.start_time, self.start_time + timedelta(hours=6)]
        )
        for ax in self.axes:
            ax.legend(loc="upper right")
        self.fig.suptitle(self.patient_name)
        self._lines = True

    def render(self, df):
        """Redraw from the accumulated results frame (Time-indexed)."""
        import matplotlib.pyplot as plt

        if self._lines is None:
            self._initialize()
        if not len(df):
            return
        t = df.index
        self._l_bg.set_data(t, df["BG"])
        self._l_cgm.set_data(t, df["CGM"])
        self._l_cho.set_data(t, df["CHO"])
        self._l_ins.set_data(t, df["insulin"])
        self._l_lbgi.set_data(t, df["LBGI"])
        self._l_hbgi.set_data(t, df["HBGI"])
        self._l_ri.set_data(t, df["Risk"])
        # incremental window management, reference law (rendering.py:68-116:
        # every panel's y-window grows with the data; the shared x-window
        # extends in 6 h blocks as time approaches the right edge)
        ax_bg, ax_cho, ax_ins, ax_risk = self.axes
        _adjust_ylim(
            ax_bg,
            float(min(df["BG"].min(), df["CGM"].min())),
            float(max(df["BG"].max(), df["CGM"].max())),
        )
        _adjust_ylim(ax_cho, float(df["CHO"].min()), float(df["CHO"].max()))
        _adjust_ylim(
            ax_ins, float(df["insulin"].min()), float(df["insulin"].max())
        )
        _adjust_ylim(
            ax_risk,
            float(df[["LBGI", "HBGI", "Risk"]].min().min()),
            float(df[["LBGI", "HBGI", "Risk"]].max().max()),
        )
        tmax = t[-1].to_pydatetime() if hasattr(t[-1], "to_pydatetime") else t[-1]
        _adjust_xlim(ax_risk, tmax)  # shared x-axis: one adjust suffices
        self.fig.canvas.draw_idle()
        try:
            self.fig.canvas.flush_events()
            plt.pause(0.001)
        except Exception:  # non-interactive backend
            pass

    def close(self):
        if self.fig is not None:
            import matplotlib.pyplot as plt

            plt.close(self.fig)
            self.fig = None
            self._lines = None
