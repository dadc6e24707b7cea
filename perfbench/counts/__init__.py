"""Frozen operation and byte counts of the port's kernels and the card's
peaks: the yardstick of the roofline and mfu metrics."""
