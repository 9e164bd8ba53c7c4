"""The benchmark's general machinery: finding a cell's files by name, the
measured window, the reduction of a device trace, the published peaks,
the draws from ``--seed`` and the comparison helpers.  Nothing here
belongs to one configuration, traffic mix or metric."""
