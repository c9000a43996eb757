"""Frozen generators of the benchmark's scenes."""
