"""Two trees' kernels timed on one card in turns: parent, change, change,
parent.

    python -m cuzk_tpu_torch.bench.kernel_ab --parent DIR [--out FILE]

``DIR`` is the root of another checkout of this repository (for example
``git archive`` of the parent commit unpacked into a directory that git
ignores).  Each turn is a fresh interpreter with that root (or this one)
first on its path, so it builds and loads that tree's kernels; it times, by
CUDA events on the same card:

- K4 (``permutation_cuda``) at each shape of ``chip_smoke.py``'s sweep;
- the per-op check kernel's ``sub`` through ``fr_op_cuda`` at 68,613 and
  4,194,304 operands;
- K1 at 65,536 pair hashes (``sponge_limbs``) and K3 on 5,000 proofs of the
  50,000-leaf arity-4 tree (``merkle.verify_proofs``).

Every turn prints one JSON line; the run prints each metric's four values
and writes them to ``FILE``.  A card is needed; the inputs are made from
seeds, the same in every turn.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

K4_SHAPES = (4096, 16384, 65536, 262144, 1048576)
FR_SUB_SHAPES = (68613, 4194304)


def _turn() -> dict:
    """One turn's numbers, from the tree this interpreter imports."""
    import numpy as np
    import torch

    from cuzk_tpu_torch import merkle, poseidon
    from cuzk_tpu_torch.field import fr
    from cuzk_tpu_torch.ops import _build, poseidon_cuda as pc
    from cuzk_tpu_torch.utils.device import nvidia_smi_name_power, require_cuda
    from cuzk_tpu_torch.utils.stats import cuda_time_ms

    dev = require_cuda()
    _build.kernels()

    def digits(seed, shape):
        rng = np.random.default_rng(seed)
        return torch.as_tensor(rng.integers(0, 1 << 16, tuple(shape) + (16,)),
                               device=dev)

    out = {"tree": os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(pc.__file__)))), "card": nvidia_smi_name_power()}
    for n in K4_SHAPES:
        st = digits(n, (n, 3))
        out[f"k4_ms_{n}"] = cuda_time_ms(
            lambda: pc.permutation_cuda(st), iters=max(3, 655360 // n))
    for n in FR_SUB_SHAPES:
        a, b = digits(n, (n,)), digits(n + 1, (n,))
        out[f"fr_sub_ms_{n}"] = cuda_time_ms(
            lambda: pc.fr_op_cuda("sub", a, b), iters=max(5, 10 * 68613 // n))
    pairs = fr.digits_to_limbs(digits(3, (65536, 2))).contiguous()
    out["k1_ms_65536"] = cuda_time_ms(
        lambda: pc.sponge_limbs(pairs, poseidon.DS_PAIR))
    tree = merkle.NaryMerkleTree(merkle.generate_test_leaves(50000, 42, device=dev),
                                 merkle.MerkleConfig(4), device=dev)
    idx = torch.as_tensor(np.random.default_rng(42).integers(0, 50000, 5000),
                          device=dev)
    pos, sib = tree.generate_batch_proofs(idx)
    proved, root = tree.levels[0][idx], tree.get_root_hash()
    out["k3_ms_5000"] = cuda_time_ms(
        lambda: merkle.verify_proofs(pos, sib, proved, root, 4))
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--out", help="write the four turns here (JSON)")
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print("TURN " + json.dumps(_turn()), flush=True)
        return []
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parent = os.path.abspath(args.parent)
    turns = []
    for label, root in (("parent", parent), ("change", here), ("change", here),
                        ("parent", parent)):
        # This file runs in the turn, the package comes from ``root``.
        code = (f"import sys, runpy; sys.path.insert(0, {root!r}); "
                f"runpy.run_path({os.path.abspath(__file__)!r}, run_name='__main__')")
        res = subprocess.run([sys.executable, "-c", code, "--turn"], cwd=root,
                             capture_output=True, text=True, timeout=900)
        line = next((ln for ln in res.stdout.splitlines()
                     if ln.startswith("TURN ")), None)
        if res.returncode != 0 or line is None:
            raise SystemExit(f"{label} turn failed ({res.returncode}):\n"
                             f"{res.stdout}{res.stderr}")
        turn = json.loads(line[5:])
        if os.path.realpath(turn["tree"]) != os.path.realpath(root):
            raise SystemExit(f"{label} turn imported {turn['tree']}, not {root}")
        turns.append({"label": label, **turn})
    for key in turns[0]:
        if key not in ("label", "tree", "card"):
            print(f"{key}: " + ", ".join(f"{t['label']} {t[key]:.4f}" for t in turns))
    print(f"card: {turns[0]['card']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(turns, f, indent=1)
    return turns


if __name__ == "__main__":
    main()
