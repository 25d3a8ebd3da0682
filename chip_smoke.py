"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``cuzk_tpu_torch/csrc/``, holds each against its
plain PyTorch version on the card, then drives the port's main path through
its public entry points at the reference's published sizes: 1,048,576 pair
hashes at batch 65536, a 50,000-leaf arity-4 tree, and 5,000 proofs
verified.  Every phase prints one line; any failure raises, and the exit
code is then non-zero.  The line before the last is one JSON object with
each kernel's launches in the main path, its error against the plain
version, and both times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

There is no CPU fallback: without a CUDA device the script exits 1 before
printing any result.  It imports neither jax nor the JAX package: the
kernels are held against the port's plain versions on the card, and the
answers against the golden values below, which
``tests/test_torch_package.py`` holds against ``cuzk_tpu.oracle`` and
``cuzk_tpu.native``.
"""

import json
import sys
import time

import numpy as np
import torch


# (operation, its arguments as cuzk_tpu.oracle takes them, value): SURVEY.md
# Appendix A's golden vectors, and hash_multiple([1..w]) at every width the
# sponge phase runs.
_MUL_A = 0x123456789ABCDEF0FEDCBA987654321011112222333344445555666677778888
_MUL_B = 0x0FEDCBA987654321123456789ABCDEF0AAAABBBBCCCCDDDDEEEEFFFF00001111
WIDTHS = (1, 2, 3, 4, 5, 8, 9, 16, 33)
GOLDEN = [
    ("mul", (_MUL_A, _MUL_B),
     0x19F690DF510F402FFEF3BF6BFC5F36BF54CAC399B184B355725667A3EEFC6378),
    ("hash_single", (42,),
     0x066E59AED12901E110F7D8459D3C2FA7705B3CE5A5EB1C7593E7E1465F85DAFB),
    ("hash_pair", (10, 20),
     0x2DD359F92D31C747E06C02B360A9F5C761777B285EDCF09724EFEF5CBD51D9BA),
    ("hash_pair", (42, 0),
     0x0F6E1ADBCD1DE3D6161CD9CFC7DAD8C98D9ACEDC903B3E94C2CC8DF4C3001580),
    ("hash_multiple", ((),), 0),
    ("hash_multiple", ((0,) * 2,),
     0x194324F01EFA21D2DCDD7453800FDE166A852E2906E0E6DE5DE6921EEB77FEEC),
    ("hash_multiple", ((0,) * 4,),
     0x1C7842D7703C243A99D6E6CA4033851791B5AE206220FC8C9BCDDE10E5BEFBDD),
    ("hash_multiple", ((0,) * 8,),
     0x2CA165C9C68473C20EB293F63DE5986E10A90FB68F6E54BD7932E5166048445D),
    ("merkle_root", ((1, 2), 2),
     0x28C245BFD4D7A4D1EE6BA330337ADC309F013D29C9326C28BA0D3CB47027FCA6),
    ("merkle_root", ((1, 2, 3, 4), 2),
     0x236B917229EEEA3EE41C637A7C3CC01F727AC1DC5108C962F564ACC1D8730E44),
    ("merkle_root", ((1, 2, 3, 4, 5), 3),
     0x28B819C1EB91377E70ED6E8BBB4C526B9B7ABABAFDCB021E135791FC4F3E25AA),
] + [
    ("hash_multiple", (tuple(range(1, w + 1)),), v) for w, v in zip(WIDTHS, (
        0x284904612E57A5ECF6AA1DEBF0DE3264C03D0556BB1EF4271F0D60B94A32A9CF,
        0x28C245BFD4D7A4D1EE6BA330337ADC309F013D29C9326C28BA0D3CB47027FCA6,
        0x2034C78DDFF46E9AC4B5683C19106D1C542876C8F936C01AA9A5BAC44F7333DA,
        0x2C12B96D3926E4862876AE9CA67CDDAD85313FA6FA5F266FB7AB683826A6A497,
        0x12B63161C4337CD9625862084FEFBCB55ABF20C75A0EF47E5EBC9180BD410248,
        0x21F04B08695BA26E5C55B40B011752FE0F576FB0A40A82C2DDE605D105730382,
        0x091CC59EBD9EF581E9F872283DA3208AB83111BEEE017C7B2C3C74867ECC421A,
        0x136DF965BF814EEDF0D8E23019DDD44DEEAD7B12D92C2A3D58780892701330AE,
        0x26971F086141E99B9258165B5D37ECB4F24C50F8737121331AF4546A10412FEF,
    ))
]
# Root of generate_test_leaves(50000, 42) at arity 4.
ROOT_50K_ARITY4 = 0x1DBAA7D03762117ABE6540A328C508C2506446C1300316FC4C9537DCE3490EFE


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)

    from cuzk_tpu_torch import constants, merkle, poseidon
    from cuzk_tpu_torch.bench import headline
    from cuzk_tpu_torch.field import fr
    from cuzk_tpu_torch.ops import _build, poseidon_cuda as pc
    from cuzk_tpu_torch.utils.device import nvidia_smi_name_power, require_cuda
    from cuzk_tpu_torch.utils.stats import cuda_time_ms

    # (0) The card.
    dev = require_cuda()
    name_power = nvidia_smi_name_power().splitlines()[0]
    print(f"phase 0 device: {name_power}", flush=True)
    print(name_power, flush=True)  # as nvidia-smi gives it

    # (1) Build.
    kernels = _build.kernels()
    print(f"phase 1 build: {kernels.build_seconds:.1f} s -> {kernels.path}",
          flush=True)

    rng = np.random.default_rng(2024)

    def digits(shape, bits=16):
        return torch.as_tensor(
            rng.integers(0, 1 << bits, tuple(shape) + (fr.NDIGITS,),
                         dtype=np.int64),
            device=dev,
        )

    # (2) The field library against the plain fr ops, on 65,536 random
    # 256-bit operands plus the four reduction regimes of test_field.py.
    n_rand = 65536
    full_a, full_b = digits((n_rand,)), digits((n_rand,))
    hi_zero = digits((1024,))
    hi_zero[:, 8:] = 0  # products < 2^256: high == 0
    small = torch.zeros_like(hi_zero)
    small[:, 0] = torch.as_tensor(rng.integers(1, 11, 1024), device=dev)
    reduced = fr.red(digits((1024,)))
    a = torch.cat([full_a, hi_zero, small, reduced])
    b = torch.cat([full_b, hi_zero.flip(0), fr.red(digits((1024,))), reduced.flip(0)])
    edges = fr.ints_to_array(
        [0, 1, constants.P - 1, constants.P, (1 << 256) - 1], device=dev
    )
    a, b = torch.cat([a, edges]), torch.cat([b, edges.flip(0)])
    op_err = 0
    for op in ("mul", "square", "power5", "add_wrap_red", "red"):
        args = (a,) if op in ("square", "power5", "red") else (a, b)
        op_err = max(op_err, max_abs_err(pc.fr_op_cuda(op, *args),
                                         pc.FR_OPS[op][1](*args)))
    ra, rb = fr.red(a), fr.red(b)
    op_err = max(op_err, max_abs_err(pc.fr_op_cuda("add_rr", ra, rb),
                                     fr.add_rr(ra, rb)))
    for c in sorted(set(constants.MDS)) + [0, 1, 65535]:
        op_err = max(op_err, max_abs_err(pc.fr_op_cuda("mul_small", a, c=c),
                                         fr.mul_small(a, c)))
    wide = fr.mul_wide(a, b)
    op_err = max(op_err, max_abs_err(pc.fr_op_cuda("reduce_wide", wide),
                                     fr.reduce_wide(wide)))
    check(op_err == 0, f"fr op kernel disagrees with plain (max err {op_err})")
    print(f"phase 2 fr ops: {a.shape[0]} operands x 8 ops, max_abs_err 0",
          flush=True)

    # (3) K1 against the plain sponge: every width, unreduced inputs and a
    # non-canonical digit d + 2^16; then every golden value.
    batch = 4096
    k1_err = 0
    x = digits((batch,))
    x[0, 3] += 1 << 16
    k1_err = max(k1_err, max_abs_err(pc.hash_single_cuda(x), poseidon.hash_single(x)))
    y = digits((batch,))
    k1_err = max(k1_err, max_abs_err(pc.hash_pair_cuda(x, y), poseidon.hash_pair(x, y)))
    for w in WIDTHS:
        g = digits((batch, w))
        g[1, w - 1, 0] += 1 << 16
        k1_err = max(k1_err, max_abs_err(pc.hash_multiple_cuda(g),
                                         poseidon.hash_multiple(g)))
    check(k1_err == 0, f"K1 disagrees with the plain sponge (max err {k1_err})")

    def row(vals):
        return torch.as_tensor(
            np.array([fr.int_to_digits(v) for v in vals], np.int64)
            .reshape(len(vals), fr.NDIGITS), device=dev)

    on_card = {
        "mul": lambda u, v: pc.fr_op_cuda("mul", row([u]), row([v]))[0],
        "hash_single": lambda v: pc.hash_single_cuda(row([v]))[0],
        "hash_pair": lambda u, v: pc.hash_pair_cuda(row([u]), row([v]))[0],
        "hash_multiple": lambda vs: pc.hash_multiple_cuda(row(vs)[None])[0],
        "merkle_root": lambda vs, arity: merkle.merkle_root(row(vs), arity),
    }
    for op, args, want in GOLDEN:
        got = fr.array_to_ints(on_card[op](*args)[None])[0]
        check(got == want, f"golden {op}{args}: {got:#x} != {want:#x}")
    print(f"phase 3 sponge: widths {list(WIDTHS)} at batch {batch} = plain, "
          f"{len(GOLDEN)} golden values ok", flush=True)

    # Kernel and plain times at the main path's shapes (pair hash, batch
    # 65536); then the main path itself, with fresh launch counts.
    pair_limbs = fr.digits_to_limbs(digits((65536, 2))).contiguous()
    k1_ms = cuda_time_ms(lambda: pc.sponge_limbs(pair_limbs, poseidon.DS_PAIR))
    pair_digits = fr.limbs_to_digits(pair_limbs)
    plain_pair = lambda: poseidon.hash_pair(pair_digits[:, 0], pair_digits[:, 1])  # noqa: E731
    k1_plain_ms = cuda_time_ms(plain_pair, iters=1, warmup=0)
    k1_err = max(k1_err, max_abs_err(
        fr.limbs_to_digits(pc.sponge_limbs(pair_limbs, poseidon.DS_PAIR)),
        plain_pair()))
    check(k1_err == 0, "K1 disagrees with plain at batch 65536")

    pc.reset_launch_counts()

    # (4) Headline: 1,048,576 pair hashes at batch 65536.
    head = headline.run()
    print(f"phase 4 headline: {head['value']:.0f} pair hashes/s "
          f"({head['vs_baseline']:.3f}x the A100 baseline) on {name_power}",
          flush=True)

    # (5) The 50,000-leaf arity-4 tree (padded to 65,536), warm build timed.
    arity, n_leaves, n_proofs = 4, 50_000, 5_000
    leaves = merkle.generate_test_leaves(n_leaves, 42, device=dev)
    cfg = merkle.MerkleConfig(arity)
    tree = merkle.NaryMerkleTree(leaves, cfg, device=dev)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    tree = merkle.NaryMerkleTree(leaves, cfg, device=dev)
    end.record()
    end.synchronize()
    build_ms = start.elapsed_time(end)

    # (6) 5,000 proofs from seeded indices, verified by K3; warm verify timed.
    idx = torch.as_tensor(
        np.random.default_rng(42).integers(0, n_leaves, n_proofs), device=dev
    )
    pos, sib = tree.generate_batch_proofs(idx)
    proved = tree.levels[0][idx]
    root = tree.get_root_hash()
    ok = merkle.verify_proofs(pos, sib, proved, root, arity)
    torch.cuda.synchronize()
    start.record()
    ok = merkle.verify_proofs(pos, sib, proved, root, arity)
    end.record()
    end.synchronize()
    verify_ms = start.elapsed_time(end)
    launches = dict(pc.launch_counts)

    root_int = tree.root_int()
    check(tree.get_tree_height() == merkle.tree_height(n_leaves, arity),
          "tree height")
    check(root_int == ROOT_50K_ARITY4,
          f"50K root {root_int:#x} != {ROOT_50K_ARITY4:#x}")
    print(f"phase 5 build: 50,000 leaves arity 4 -> root {root_int:#x} (golden); "
          f"warm build {build_ms:.3f} ms on {name_power}", flush=True)

    check(bool(ok.all()), "valid proofs failed to verify")
    tampered_leaves, tampered_sib = proved.clone(), sib.clone()
    tampered_leaves[10, 0] ^= 1
    tampered_sib[20, 3, 1, 5] ^= 1
    tampered_sib[30, 0, 0, 2] += 1 << 16  # aliases the valid digit mod 2^16
    bad = merkle.verify_proofs(pos, tampered_sib, tampered_leaves, root, arity)
    check(sorted(torch.nonzero(~bad).flatten().tolist()) == [10, 20, 30],
          "tampered proofs: exactly 10, 20, 30 must fail")
    k3_ms = cuda_time_ms(lambda: merkle.verify_proofs(
        pos, tampered_sib, tampered_leaves, root, arity))
    start.record()
    plain_ok = merkle._verify_plain(pos, tampered_sib, tampered_leaves, root, arity)
    end.record()
    end.synchronize()
    k3_plain_ms = start.elapsed_time(end)
    k3_err = max_abs_err(bad, plain_ok)
    check(k3_err == 0, "K3 disagrees with the plain verify")
    print(f"phase 6 verify: 5,000 proofs all true, tampered 10/20/30 false, "
          f"K3 = plain; warm verify {verify_ms:.3f} ms on {name_power}",
          flush=True)

    for name in ("sponge", "verify"):
        check(launches[name] > 0, f"kernel {name} never ran in the main path")
    record = {"kernels": [
        {"name": "sponge", "route": "cuda",
         "source": "cuzk_tpu_torch/csrc/poseidon_kernels.cu",
         "replaces": "cuzk_tpu/ops/poseidon_pallas.py:488",
         "launches": launches["sponge"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "verify", "route": "cuda",
         "source": "cuzk_tpu_torch/csrc/poseidon_kernels.cu",
         "replaces": "cuzk_tpu/ops/poseidon_pallas.py:385",
         "launches": launches["verify"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms},
    ], "pair_hashes_per_s": head["value"], "build_50k_ms": build_ms,
        "verify_5k_ms": verify_ms, "card": name_power}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
