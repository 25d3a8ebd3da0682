"""CLI alias: ``python -m cuzk_tpu_torch.bench.cli`` -> the full benchmark suite."""

from cuzk_tpu_torch.bench.run import main

if __name__ == "__main__":
    main()
