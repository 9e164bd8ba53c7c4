"""Population-scale cohort simulation on the rollout kernel.

Counterpart of ``examples/fast_cohort_sim.py``: 4096 virtual patients for
a simulated day on the rollout kernel K1a (``engine='pallas'``), the
high-throughput analog of the reference's batch_sim over a process pool
(reference: simulation/sim_engine.py:65-76).  It runs
:func:`~simglucose_tpu_torch.sim.engine.simulate_cohort`, the
pandas-free core of ``simulate()``, and prints the JAX script's line.  Run
with ``python -m simglucose_tpu_torch.examples.fast_cohort_sim``.
"""
from datetime import timedelta


def main(n_patients: int = 4096, hours: float = 24.0, device="cuda") -> dict:
    """Returns the printed numbers."""
    from simglucose_tpu_torch.envs.build import cohort_names
    from simglucose_tpu_torch.sim.engine import simulate_cohort

    res = simulate_cohort(
        sim_time=timedelta(hours=hours),
        patient_names=cohort_names(n_patients),  # 30 archetypes cycled
        controller="BB",
        scenario_seed=7,
        engine="pallas",
        device=device,
    )
    bg = res.traj.BG
    tir = ((bg >= 70) & (bg <= 180)).mean() * 100
    print(f"cohort: {bg.size} samples; BG mean {bg.mean():.1f} mg/dL; "
          f"time-in-[70,180] {tir:.1f}%")
    return dict(samples=bg.size, bg_mean=float(bg.mean()), tir=float(tir))


if __name__ == "__main__":
    main()
