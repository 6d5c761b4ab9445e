from .perf_sweep import run_sweep, sweep_main
