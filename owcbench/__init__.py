"""The benchmark of the PyTorch/CUDA port (``lmms_owc_tpu_torch``) on NVIDIA GPUs.

``python3 owcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``. The benchmark imports the port and
nothing of JAX or of the JAX package.
"""
