"""The benchmark's hairball cell, ``hairball-primary``, in the port's test
run: the tests of ``rtbench/tests/test_rtbench_hairball.py`` (the frozen
hairball generator and framing against the port's, the configuration, the
``primary_stats`` driver and its counters at a tiny size on the CPU, a
planted fault), collected here as well."""

from rtbench.tests.test_rtbench_hairball import *  # noqa: F401,F403
