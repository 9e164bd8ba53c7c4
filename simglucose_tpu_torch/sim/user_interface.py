"""Interactive CLI wizard over :func:`simglucose_tpu_torch.sim.engine.simulate`.

Counterpart of ``simglucose_tpu/sim/user_interface.py:22-279``, the same
prompts in the same order.  Interactive parity with the reference's entry point
(reference: simulation/user_interface.py:29-404): the same prompt order
(animate -> parallel -> save path -> sim time -> scenario -> patients ->
CGM sensor -> sensor seed -> pump -> controller), the same patient-group
menu with a By-ID sub-loop ('D' to finish, duplicates rejected), the same
breakfast/lunch/dinner + optional-snacks custom-scenario dialogue, and the
reference's macOS animate-and-parallel guard; everything then routes into
the port's cohort simulation (on the card unless ``device="cpu"`` is
passed).  Run it with ``python -m simglucose_tpu_torch.sim.user_interface``.
"""
from __future__ import annotations

import platform
from datetime import datetime, timedelta
from typing import Optional

from simglucose_tpu_torch import params as tables
from simglucose_tpu_torch.sim.engine import simulate as _simulate


def _pick_from(prompt: str, choices: list, allow_multi: bool = False):
    """Numbered selection wizard (reference: user_interface.py:96-121)."""
    while True:
        print(prompt)
        for i, c in enumerate(choices):
            print(f"[{i + 1}] {c}")
        raw = input(">>> ").strip()
        try:
            if allow_multi:
                idxs = [int(tok) for tok in raw.replace(",", " ").split()]
                if all(1 <= i <= len(choices) for i in idxs) and idxs:
                    return [choices[i - 1] for i in idxs]
            else:
                i = int(raw)
                if 1 <= i <= len(choices):
                    return choices[i - 1]
        except ValueError:
            pass
        print("Invalid input, please try again.")


def pick_patients():
    """Group menu + By-ID sub-loop (reference: user_interface.py:29-93):
    'D' finishes the ID selection, duplicates are rejected."""
    names = tables.patient_names()
    while True:
        raw = input(
            "Select virtual patients:\n"
            "[1] All\n"
            "[2] All Adolescents\n"
            "[3] All Adults\n"
            "[4] All Children\n"
            "[5] By ID\n"
            ">>> "
        ).strip()
        try:
            select1 = int(raw)
        except ValueError:
            print("Please input an integer. Try again")
            continue
        if 1 <= select1 <= 5:
            break
        print("Input 1 to 5 please!")

    if select1 == 1:
        return list(names)
    if select1 == 2:
        return [n for n in names if n.startswith("adolescent")]
    if select1 == 3:
        return [n for n in names if n.startswith("adult")]
    if select1 == 4:
        return [n for n in names if n.startswith("child")]

    patients, hist = [], set()
    while True:
        print("Select patient:")
        for i, p in enumerate(names):
            print(f"[{i + 1}] {p}")
        print("[D] Done")
        raw = input(">>> ").strip()
        if raw in ("D", "d"):
            if patients:
                return patients
            print("Select at least one patient.")
            continue
        try:
            i = int(raw)
        except ValueError:
            print("Please input a number or 'D' or 'd'.")
            continue
        if not (1 <= i <= len(names)):
            print(f"Please input an number from 1 to {len(names)}.")
            continue
        if i in hist:
            print(f"{names[i - 1]} is already selected!")
            continue
        hist.add(i)
        patients.append(names[i - 1])


def pick_cgm_sensor() -> str:
    return _pick_from("Select the CGM sensor:", tables.sensor_names())


def pick_cgm_seed() -> int:
    while True:
        raw = input("Random seed for the CGM sensor [enter for 0]: ").strip()
        if not raw:
            return 0
        try:
            return int(raw)
        except ValueError:
            print("Invalid input, please enter an integer.")


def pick_insulin_pump() -> str:
    return _pick_from("Select the insulin pump:", tables.pump_names())


def input_custom_scenario():
    """Breakfast/lunch/dinner + optional snacks, hours since midnight
    (reference: user_interface.py:214-242)."""
    meals = []
    for label in ("breakfast", "lunch", "dinner"):
        t = float(input(f"Input {label} time (hr): "))
        size = float(input(f"Input {label} size (g): "))
        meals.append((t, size))
    while True:
        go_on = input("Continue input snack (y/n)? ").strip().lower()
        if go_on == "n":
            break
        if go_on != "y":
            continue
        t = float(input("Input snack time (hr): "))
        size = float(input("Input snack size (g): "))
        meals.append((t, size))
    return meals


def pick_scenario():
    kind = _pick_from(
        "Select scenario:", ["Random Scenario", "Custom Scenario"]
    )
    if kind == "Random Scenario":
        return None
    return input_custom_scenario()


def pick_start_time() -> datetime:
    while True:
        raw = input("Input simulation start time (hr) [enter for 0]: ").strip()
        if not raw:
            return datetime(2018, 1, 1, 0, 0, 0)
        try:
            h = float(raw)
            return datetime(2018, 1, 1) + timedelta(hours=h)
        except ValueError:
            print("Invalid input, please try again.")


def pick_sim_time() -> timedelta:
    while True:
        raw = input("Input simulation time (hr) [enter for 24]: ").strip()
        if not raw:
            return timedelta(hours=24)
        try:
            return timedelta(hours=float(raw))
        except ValueError:
            print("Invalid input, please try again.")


def pick_controller():
    return _pick_from(
        "Select controller:", ["Basal-Bolus Controller", "PID Controller"]
    ).split()[0].replace("Basal-Bolus", "BB")


def pick_save_path() -> Optional[str]:
    raw = input("Folder name to save results [enter to skip]: ").strip()
    return raw or None


def _pick_yn(prompt: str) -> bool:
    """y/n loop that re-asks on anything else (reference:
    user_interface.py:275-297)."""
    while True:
        select = input(prompt).strip().lower()
        if select == "y":
            return True
        if select == "n":
            return False


def pick_animate() -> bool:
    return _pick_yn("Show animation? (y/n) ")


def pick_parallel() -> bool:
    return _pick_yn("Use multiple processes? (y/n) ")


def simulate(
    sim_time: Optional[timedelta] = None,
    scenario="__unset__",
    scenario_seed: Optional[int] = None,
    controller=None,
    patient_names=None,
    cgm_name: Optional[str] = None,
    cgm_seed: Optional[int] = None,
    insulin_pump_name: Optional[str] = None,
    start_time: Optional[datetime] = None,
    save_path: Optional[str] = "__unset__",
    animate: Optional[bool] = None,
    parallel: Optional[bool] = None,
    **kwargs,
):
    """Interactive-capable top-level simulate, prompting in the reference's
    order (reference: user_interface.py:303-385): anything left unset is
    asked for, then the cohort runs as one batch (``kwargs`` go to
    :func:`~simglucose_tpu_torch.sim.engine.simulate`, ``device`` among
    them) and the analysis report is written."""
    if animate is None:
        animate = pick_animate()
    if parallel is None:
        parallel = pick_parallel()
    if platform.system() == "Darwin" and (animate and parallel):
        # literal reference guard (user_interface.py:334-337); here one
        # batch renders in chunks, but the contract is kept
        raise ValueError(
            "animate and parallel cannot be turned on at the same time "
            "in macOS."
        )
    if save_path == "__unset__":
        save_path = pick_save_path()
    if sim_time is None:
        sim_time = pick_sim_time()
    if scenario == "__unset__":
        scenario = pick_scenario()
    if start_time is None:
        # the reference prompts the start hour with the scenario
        # (user_interface.py:205-211)
        start_time = pick_start_time()
    if patient_names is None:
        patient_names = pick_patients()
    if cgm_name is None:
        cgm_name = pick_cgm_sensor()
    if cgm_seed is None:
        cgm_seed = pick_cgm_seed()
    if insulin_pump_name is None:
        insulin_pump_name = pick_insulin_pump()
    if controller is None:
        controller = pick_controller()

    return _simulate(
        sim_time=sim_time,
        scenario=scenario,
        scenario_seed=scenario_seed,
        controller=controller,
        patient_names=patient_names,
        cgm_name=cgm_name,
        cgm_seed=cgm_seed,
        insulin_pump_name=insulin_pump_name,
        start_time=start_time,
        save_path=save_path,
        animate=animate,
        parallel=parallel,
        **kwargs,
    )


def main():  # pragma: no cover
    import logging

    logging.basicConfig(level=logging.INFO)
    simulate()


if __name__ == "__main__":  # pragma: no cover
    main()
