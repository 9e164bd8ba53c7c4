"""The per-patient summary of a simulated day that a population study
keeps (Kovatchev's risk indices; time in range 70-180 mg/dL), reduced on
the device from the ``[T, B]`` BG plane.  Both the timed calls and the
reference's plane go through it."""
from __future__ import annotations

import torch

def summary(bg: torch.Tensor) -> torch.Tensor:
    """``[4, B]``: mean BG, share of steps in 70-180, LBGI, HBGI."""
    bg = bg.float()
    f = 1.509 * (torch.pow(torch.log(torch.clamp(bg, min=1.0)), 1.084) - 5.381)
    r = 10.0 * f * f
    return torch.stack([bg.mean(0), ((bg >= 70.0) & (bg <= 180.0)).float().mean(0),
                        torch.where(f < 0, r, 0.0).mean(0), torch.where(f > 0, r, 0.0).mean(0)])


# A lane is off where one of its stats leaves these: mean BG relatively,
# time in range by two steps of the day, the risk indices by 0.01 plus a
# thousandth.  A lane whose trajectory only carries the rounding of another
# order of operations stays well inside; a lane whose closed loop took
# another course (a pump step or an episode's end one step apart) does not.
def lanes_off(got: torch.Tensor, ref: torch.Tensor, n_steps: int) -> torch.Tensor:
    """``[B]`` bool: the lanes whose summary ``got`` leaves ``ref``'s."""
    d = (got.double() - ref.double()).abs()
    r = ref.double().abs()
    return ((d[0] > 1e-3 * r[0]) | (d[1] > 2.0 / n_steps + 1e-9)
            | (d[2] > 0.01 + 1e-3 * r[2]) | (d[3] > 0.01 + 1e-3 * r[3])
            | ~torch.isfinite(got).all(0))


def bg_gap(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``[B]``: each lane's relative gap of mean BG."""
    g, r = got[0].double(), ref[0].double()
    return ((g - r).abs() / r.abs()).nan_to_num(float("inf"))
