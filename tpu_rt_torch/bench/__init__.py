"""The app (cli, viewer, tune_quad, scaling), the suite workload and the
measurement harness (bench, bench_suite, calibrate, bench_diff)."""
