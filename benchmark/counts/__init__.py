"""Frozen operation and byte counts, one file per kernel or step, so that a
roofline or a share of the peak reads the same work whatever implements
it.  Each file gives ``count(**shape) -> {"flop", "sfu", "bytes"}`` for one
launch or step."""
