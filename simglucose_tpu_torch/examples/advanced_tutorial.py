"""Programmatic batch simulation: custom scenario, cohort, report.

Counterpart of ``examples/advanced_tutorial.py`` (capability parity:
reference examples/advanced_tutorial.py).  Run with ``python -m
simglucose_tpu_torch.examples.advanced_tutorial``; needs pandas (and
matplotlib for the report written to ``save_path``).
"""
from datetime import datetime, timedelta


def main(save_path="./results", hours: float = 24.0, device="cuda"):
    """Returns the cohort frame and the batch_sim frames."""
    from simglucose_tpu_torch.sim import SimObj, batch_sim, simulate

    # --- One-call cohort simulation: the cohort runs as one batch --------
    df = simulate(
        sim_time=timedelta(hours=hours),
        patient_names=["adolescent#001", "adolescent#002", "adult#001"],
        controller="BB",
        scenario=[(7.0, 45.0), (12.0, 70.0), (18.0, 80.0)],  # (hour, grams)
        start_time=datetime(2018, 1, 1, 0, 0, 0),
        save_path=save_path,
        device=device,
    )
    # the frame's attrs hold the reward plane, an array, which pandas'
    # groupby cannot compare when it joins the groups: describe a copy
    # without it (the JAX script's line fails there)
    bg = df["BG"].copy()
    bg.attrs = {}
    print(bg.groupby(level=0).describe())

    # --- Familiar SimObj/batch_sim surface -------------------------------
    sim_objects = [
        SimObj(
            patient_name=name,
            controller="BB",
            sim_time=timedelta(hours=hours / 2),
            start_time=datetime(2018, 1, 1),
            seed=1,
            device=device,
        )
        for name in ("child#001", "child#002")
    ]
    results = batch_sim(sim_objects, parallel=True)  # fused into one batch
    for r in results:
        print(r.BG.describe())
    return df, results


if __name__ == "__main__":
    main()
