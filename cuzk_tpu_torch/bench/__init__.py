"""Benchmarks of the port (``python -m cuzk_tpu_torch.bench.headline``)."""
