"""The benchmark's harness for nerfmeshes_tpu_torch: cells found by name
(BENCHMARK.json -> configs/, traffic/, limits/, metrics/), the kinds of
cell that drive the program, a plain PyTorch reference that decides
`correct`, and the yardstick (operation counts, the device trace's
reduction, the statistics)."""
