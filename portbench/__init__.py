"""The benchmark of the PyTorch/CUDA port (`repro_torch`).

One command runs one cell once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the repository root names the cells; each cell's
configuration (`configs/<name>.json`), traffic mix (`traffic/<name>.json`)
and per-layer metric readers (`metrics/<name>.py`) are found by name, so a
new cell is new files plus new entries. Everything here is the yardstick:
the Graph500 generator (`graph500`), the plain reference BFS and the
comparison that decides `correct` (`reference`), the kernels' byte counts
(`bounds`), the trace readers (`trace`) and the load generators
(`drivers`). Nothing here imports JAX or the JAX package.
"""
