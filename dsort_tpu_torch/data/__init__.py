"""Partitioning and one-int-per-line text IO (numpy, host side)."""
