"""The benchmark of the PyTorch/CUDA port (``cuzk_tpu_torch``) on one
NVIDIA H100: ``python -m zkbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.  See ``run.py``."""
