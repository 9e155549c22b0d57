"""The benchmark of longreadmapper_tpu_torch: one cell of BENCHMARK.json a
run (`python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`).  Configurations, traffic mixes and metric readers are data
and small files found by the names in BENCHMARK.json; the yardstick
(traffic generation, the plain reference, the comparison, the peaks and the
reduction of traces to metrics) lives here and imports neither JAX nor the
JAX package."""
