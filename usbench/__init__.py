"""usbench: the benchmark of qups_tpu_torch, the PyTorch and CUDA port.

One command runs one cell once (``python3 -m usbench.run``, see
``run.py``); ``BENCHMARK.json`` at the repository's root names the cells,
the configurations and the metrics, and the files under this folder hold
each of them (``spec.py``). Nothing here imports JAX or the JAX package;
the plain reference (``reference/``) and the frozen counts (``counts/``)
import nothing of the program.
"""
