"""The benchmark's diffuse frame cell, ``sanmiguel-diffuse-frames``, in the
port's test run: the tests of ``rtbench/tests/test_rtbench_diffuse_frames.py``
(the port's sorted diffuse frames at a tiny size on the CPU against the
float64 diffuse frame reference, the planted faults and the control, the
traced line's readers, and ``Renderer.frame_stats``), collected here as
well."""

from rtbench.tests.test_rtbench_diffuse_frames import *  # noqa: F401,F403
