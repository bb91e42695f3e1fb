"""The benchmark of the PyTorch / CUDA port (``repro_torch``).

One command runs one cell once (``python3 perfbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``); everything a cell needs
is found by name under this folder (README.md).  Nothing here imports
the JAX package or JAX, and the plain reference (``reference/``) imports
nothing of the port.
"""
