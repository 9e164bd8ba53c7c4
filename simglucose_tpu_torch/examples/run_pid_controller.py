"""PID closed loop.

Counterpart of ``examples/run_pid_controller.py`` (capability parity:
reference examples/run_pid_controller.py): one patient for a day under
PID on the rollout kernel K1a.  Run with ``python -m
simglucose_tpu_torch.examples.run_pid_controller``; needs pandas.
"""
from datetime import datetime, timedelta


def main(hours: float = 24.0, device="cuda"):
    """Returns the results frame."""
    from simglucose_tpu_torch.sim import simulate

    df = simulate(
        sim_time=timedelta(hours=hours),
        patient_names=["adolescent#001"],
        controller="PID",
        start_time=datetime(2018, 1, 1),
        device=device,
    )
    print(df.loc["adolescent#001"][["BG", "CGM", "insulin"]].describe())
    return df


if __name__ == "__main__":
    main()
