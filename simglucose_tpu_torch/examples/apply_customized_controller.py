"""Write your own controller as a pure function.

Counterpart of ``examples/apply_customized_controller.py`` (capability
parity: reference examples/apply_customized_controller.py).  A controller
is ``(init_state, policy)`` where ``policy(ctrl_state, prev_step_result)
-> (ctrl_state, CtrlAction)``; on the port it is batch-native (the
result's leaves are ``[B]`` tensors) and runs on the eager env path.  Run
with ``python -m simglucose_tpu_torch.examples.apply_customized_controller``;
needs pandas.
"""
from datetime import datetime, timedelta

import torch


def make_my_controller(target=120.0, gain=5e-4, device="cuda"):
    """Proportional-only controller with state tracking the last CGM."""
    from simglucose_tpu_torch.core.types import CtrlAction

    def policy(last_cgm, result):
        cgm = result.observation.CGM
        basal = torch.clamp(gain * (cgm - target), min=0.0)
        return cgm, CtrlAction(basal=basal, bolus=torch.zeros_like(basal))

    init_state = torch.tensor(140.0, dtype=torch.float32, device=device)
    return init_state, policy


def main(hours: float = 12.0, device="cuda"):
    """Returns the results frame."""
    from simglucose_tpu_torch.sim import simulate

    df = simulate(
        sim_time=timedelta(hours=hours),
        patient_names=["adolescent#001"],
        controller=make_my_controller(device=device),
        start_time=datetime(2018, 1, 1, 6),
        device=device,
    )
    print(df.loc["adolescent#001"].BG.describe())
    return df


if __name__ == "__main__":
    main()
