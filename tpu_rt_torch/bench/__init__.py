"""Benchmark workload definitions (the suite cameras)."""
