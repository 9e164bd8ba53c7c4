"""Interactive simulation wizard.

Counterpart of ``examples/run_user_interface.py`` (capability parity:
reference examples/run_user_interface.py).  Run with ``python -m
simglucose_tpu_torch.examples.run_user_interface``; it asks its questions
on standard input, and the results frame needs pandas.
"""


def main(**kwargs):
    """The wizard; ``kwargs`` (``device`` among them) go to
    :func:`simglucose_tpu_torch.sim.user_interface.simulate`, and what they
    leave unset is asked for."""
    from simglucose_tpu_torch.sim.user_interface import simulate

    return simulate(**kwargs)


if __name__ == "__main__":
    main()
