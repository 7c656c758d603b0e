"""The benchmark of ``flux_fp8_api_tpu_torch`` on an NVIDIA H100: cells of
BENCHMARK.json run by ``python3 -m portbench.run``. See PERF.md."""
