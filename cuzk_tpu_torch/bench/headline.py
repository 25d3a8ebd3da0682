"""Headline benchmark of the port: Poseidon pair-hash throughput on one card.

The same workload as the root ``bench.py``: 1,048,576 pair hashes at batch
65536, four distinct device-resident input buffers cycled so that no call
repeats its inputs, gated by bit-exactness against the plain PyTorch
sponge (:func:`cuzk_tpu_torch.poseidon.hash_pair`, run on the same card)
on a 1024-hash sample.  Timed with
CUDA events after a warm-up, through the public entry point
``hash_pair_cuda`` (digit-to-limb conversion included).  Baseline: the
reference's A100 CUDA number, 2,145,027 hashes/s (BASELINE.md).

Run: ``python -m cuzk_tpu_torch.bench.headline``.  Prints one JSON line.
It needs a Hopper card and raises without one.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from cuzk_tpu_torch import poseidon
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import hash_pair_cuda
from cuzk_tpu_torch.utils.device import nvidia_smi_name_power, require_cuda
from cuzk_tpu_torch.utils.errors import ComputationError

BASELINE_PAIR_HASHES_PER_S = 2_145_027.0  # A100 CUDA, BASELINE.md
BATCH = 65536
TOTAL = 1_048_576
GATE_SAMPLE = 1024
N_BUFFERS = 4


def run(seed: int = 42) -> dict:
    device = require_cuda()
    rng = np.random.default_rng(seed)
    bufs = [
        tuple(
            torch.as_tensor(
                rng.integers(0, 1 << 16, (BATCH, fr.NDIGITS), dtype=np.int64),
                device=device,
            )
            for _ in range(2)
        )
        for _ in range(N_BUFFERS)
    ]

    out = hash_pair_cuda(*bufs[0])
    left, right = (b[:GATE_SAMPLE] for b in bufs[0])
    if not torch.equal(out[:GATE_SAMPLE], poseidon.hash_pair(left, right)):
        raise ComputationError("headline: kernel disagrees with the plain sponge")
    for b in bufs[1:]:
        hash_pair_cuda(*b)
    torch.cuda.synchronize()

    iters = TOTAL // BATCH
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        hash_pair_cuda(*bufs[i % N_BUFFERS])
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3
    rate = iters * BATCH / seconds
    return {
        "metric": "poseidon_pair_hashes_per_s_per_chip",
        "value": rate,
        "unit": "hashes/s",
        "vs_baseline": rate / BASELINE_PAIR_HASHES_PER_S,
        "hashes": iters * BATCH,
        "batch": BATCH,
        "seconds": seconds,
        "device": torch.cuda.get_device_name(0),
        "name_power_limit": nvidia_smi_name_power().splitlines()[0],
    }


def main() -> None:
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
