"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``cuzk_tpu_torch/csrc/``, holds each against its
plain PyTorch version on the card, then drives the port's paths through
their public entry points at the reference's published sizes:

- slice 1 (phases 4-6): 1,048,576 pair hashes at batch 65536, a
  50,000-leaf arity-4 tree, and 5,000 proofs verified;
- slice 2 (phases 8-9): the engines (``verify_engines_match``, the CUDA
  engine's raw permutation of 65,536 states, the packed entry points) and
  the Poseidon benchmark suite (its gate, then the reference's Small,
  Medium and Large configs, pairs and single: Small and Medium through the
  coalescing engine over the packed wire, Large synchronously);
- slice 3 (phases 10-13): the deduplicated ``verify_each`` of phase 6's
  5,000 proofs from host arrays, valid, tampered and declined, against the
  verify kernel; its device program against the plain version on the
  reference's 5,000 proofs of a 1,024-leaf tree; one tampered proof in
  50,000 isolated; ``NaryMerkleTree.verify_batch_proofs`` on 5,000 and
  50,000 proofs already on the card against one verify-kernel launch; 64
  incremental updates and an insert against a rebuild, 16 x 4,096 batch
  trees, and a save/load round trip of the 50K tree;
- slice 4 (phase 14 and the lanes in phases 3 and 6): K1 and K3 at every
  G they are built for (``pc.LANES``: one thread per state, or three lanes
  holding one state element each) against their plain versions at edge
  batches, and a latency sweep of each kernel under each G beside the
  automatic choice.  Phase 1 prints ptxas's record
  of every kernel (registers, stack frame, spills) and fails if K1 or K3
  uses local memory.

Each path runs with the launch counts set to 0 just before it and read just
after; in slice 3 each main-path call is counted alone and must make
exactly the launches of its route.  Every phase prints one line; any
failure raises, and the exit code is then non-zero.  The line before the
last is one JSON object with each kernel's launches in the main path, its
error against the plain version, both times, its bound (the larger of its
bytes over the card's memory rate and its 32-bit multiplies over the
card's integer multiply-add rate at ``clocks.max.sm``) and the share of it
reached, the lanes chosen at that shape, then the slice-3 launch
counts (``slice3_sponge_launches``, ``slice3_verify_launches``) and times
(dedup against the verify kernel at 5,000 and 50,000 proofs from the host,
the tree method against the verify kernel on proofs on the card, the device
program against its plain version, updates against a rebuild, batch
trees), the slice-4 sweep and the ptxas record; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

There is no CPU fallback: without a CUDA device the script exits 1 before
printing any result.  It imports neither jax nor the JAX package: the
kernels are held against the port's plain versions on the card, and the
answers against the golden values below, which
``tests/test_torch_package.py`` holds against ``cuzk_tpu.oracle`` and
``cuzk_tpu.native``.
"""

import itertools
import json
import os
import subprocess
import sys
import tempfile
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
    ("permutation", ([1, 2, 3],), [
        0x07B845866686A60A43F75F0CD778887CC9C304376FCD0B3DE6964E45B9630501,
        0x0EF091199ADBCCB5A4F16D125495A5088EFAD30E7157B84E7429C087D234C932,
        0x157A12C9C56AE74429660DFB6AEBDF9148E6AFB977080BE9C424CCB07472AE04,
    ]),
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
# The bound's rates (NVIDIA H100 SXM): device memory 3.35 TB/s; 64 32-bit
# integer multiply-adds a clock on each SM (CUDA C Programming Guide,
# throughput table, compute capability 9.0), at the card's clocks.max.sm.
# A permutation at the reference's semantics computes 44,096 32 x 32-bit
# limb products (80 S-boxes of 436, 576 one-limb MDS products of 16), each
# two multiply results (low and high word).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_CLOCK_PER_SM = 64
MULTIPLIES_PER_PERMUTATION = 2 * 44_096
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

    from cuzk_tpu_torch import constants, engine, merkle, poseidon
    from cuzk_tpu_torch.bench import headline
    from cuzk_tpu_torch.bench import run as bench_run
    from cuzk_tpu_torch.field import fr
    from cuzk_tpu_torch.ops import _build, poseidon_cuda as pc
    from cuzk_tpu_torch.utils.device import nvidia_smi_name_power, require_cuda
    from cuzk_tpu_torch.utils.stats import cuda_time_ms

    # (0) The card.
    dev = require_cuda()
    name_power = nvidia_smi_name_power().splitlines()[0]
    print(f"phase 0 device: {name_power}", flush=True)
    print(name_power, flush=True)  # as nvidia-smi gives it

    # (1) Build, and ptxas's record of each kernel: K1 and K3 must keep
    # every operand in registers under each G.
    kernels = _build.kernels()
    print(f"phase 1 build: {kernels.build_seconds:.1f} s -> {kernels.path}",
          flush=True)
    for name in sorted(kernels.ptxas):
        rec = kernels.ptxas[name]
        print(f"phase 1 ptxas {name}: {rec}", flush=True)
        if name.startswith(("sponge_kernel", "verify_kernel")):
            check(rec.get("stack_frame") == 0 and rec.get("spill_stores") == 0
                  and rec.get("spill_loads") == 0,
                  f"{name} uses local memory: {rec}")
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=30,
    ).stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def bound(permutations, nbytes):
        """(bound_ms, bound_by) of work of ``permutations`` permutations
        moving ``nbytes`` bytes."""
        ops_s = permutations * MULTIPLIES_PER_PERMUTATION / (
            sms * IMAD_PER_CLOCK_PER_SM * clock_hz)
        bytes_s = nbytes / HBM_BYTES_PER_S
        return max(ops_s, bytes_s) * 1e3, (
            "operations" if ops_s >= bytes_s else "bytes")

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
    # The reduced-operand mul_small at every MDS coefficient, and at its
    # edge (a = p - 1, c = 26: high = 4, and the second fold must not be
    # needed).
    for c in sorted(set(constants.MDS)):
        op_err = max(op_err, max_abs_err(pc.fr_op_cuda("mul_small_rr", ra, c=c),
                                         fr.mul_small(ra, c)))
    top = fr.ints_to_array([constants.P - 1] * 64, device=dev)
    op_err = max(op_err, max_abs_err(pc.fr_op_cuda("mul_small_rr", top, c=26),
                                     fr.mul_small(top, 26)))
    wide = fr.mul_wide(a, b)
    op_err = max(op_err, max_abs_err(pc.fr_op_cuda("reduce_wide", wide),
                                     fr.reduce_wide(wide)))
    check(op_err == 0, f"fr op kernel disagrees with plain (max err {op_err})")
    print(f"phase 2 fr ops: {a.shape[0]} operands x {len(pc.FR_OPS)} ops, "
          f"mul_small_rr(p - 1, 26): max_abs_err 0", flush=True)

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
    # Every G at edge batches (1, G - 1, G + 1, 31, 33, and 517, not a
    # multiple of the block): one plain sponge per width over all of them.
    edge_sizes = sorted({1, 31, 33, 517} | {g + d for g in pc.LANES
                                           for d in (-1, 1) if g + d > 0})
    for w in WIDTHS:
        g_all = digits((sum(edge_sizes), w))
        g_all[::7, w - 1, 0] += 1 << 16
        want = poseidon.hash_multiple(g_all)
        limbs = fr.digits_to_limbs(g_all).contiguous()
        for g in pc.LANES:
            o = 0
            for size in edge_sizes:
                got = pc.sponge_limbs(limbs[o:o + size], poseidon.DS_MULTIPLE,
                                      lanes=g)
                k1_err = max(k1_err, max_abs_err(fr.limbs_to_digits(got),
                                                 want[o:o + size]))
                o += size
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
        "permutation": lambda vs: pc.permutation_cuda(row(vs)),
    }
    for op, args, want in GOLDEN:
        got = fr.array_to_ints(on_card[op](*args))
        got = got if isinstance(want, list) else got[0]
        check(got == want, f"golden {op}{args}: {got} != {want}")
    print(f"phase 3 sponge: widths {list(WIDTHS)} at batch {batch} = plain; "
          f"every G {list(pc.LANES)} at batches {edge_sizes} = plain; "
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
    k3_lanes = pc.choose_lanes(n_proofs, pc.resident_states(dev, "verify"))
    # Every G at this shape, and at edge batches over arities 2, 3, 4 and 8
    # with tampered leaves, siblings and positions out of range.
    limbs5k = (pos.clamp(-1, arity).to(torch.int32).contiguous(),
               fr.digits_to_limbs(tampered_sib).contiguous(),
               fr.digits_to_limbs(tampered_leaves).contiguous(),
               fr.digits_to_limbs(root).contiguous())
    for g in pc.LANES:
        k3_err = max(k3_err, max_abs_err(pc.verify_limbs(*limbs5k, arity, lanes=g),
                                         plain_ok))
    k3_edges = sorted({1, 31, 33, 517} | {g + d for g in pc.LANES
                                         for d in (-1, 1) if g + d > 0})
    for a_ in (2, 3, 4, 8):
        small_tree = merkle.build_tree_levels(digits((300,)), a_)
        idx_e = torch.as_tensor(np.arange(max(k3_edges)) * 7 % 300, device=dev)
        pe, se = merkle.generate_proofs(small_tree, a_, idx_e)
        le = small_tree[0][idx_e].clone()
        pe = pe.to(torch.int64)
        pe[::11, 0] = a_ + 1
        pe[5::13, -1] = -1
        le[3::17, 2] ^= 1
        se[7::19, 0, 0, 1] ^= 1
        want = merkle._verify_plain(pe, se, le, small_tree[-1][0], a_)
        args = (pe.clamp(-1, a_).to(torch.int32).contiguous(),
                fr.digits_to_limbs(se).contiguous(),
                fr.digits_to_limbs(le).contiguous(),
                fr.digits_to_limbs(small_tree[-1][0]).contiguous())
        for g in pc.LANES:
            for size in k3_edges:
                got = pc.verify_limbs(*(t[:size] for t in args[:3]), args[3],
                                      a_, lanes=g)
                k3_err = max(k3_err, max_abs_err(got, want[:size]))
        check(bool(want.any()) and not bool(want.all()), "K3 edge batch mixes")
    check(k3_err == 0, "K3 disagrees with the plain verify")
    print(f"phase 6 verify: 5,000 proofs all true, tampered 10/20/30 false, "
          f"K3 = plain at every G {list(pc.LANES)} (auto G = {k3_lanes}) and "
          f"at batches {k3_edges} over arities 2, 3, 4, 8; warm verify "
          f"{verify_ms:.3f} ms on {name_power}", flush=True)
    # The 50K build's K1 launches, one per level, each timed alone.
    build_k1_ms = 0.0
    for lv in tree.levels[:-1]:
        lv_limbs = fr.digits_to_limbs(lv).contiguous().view(-1, arity, fr.NLIMBS)
        build_k1_ms += cuda_time_ms(
            lambda x=lv_limbs: pc.sponge_limbs(x, poseidon.DS_MULTIPLE), iters=5)
    print(f"phase 6 build's K1 launches: {build_k1_ms:.3f} ms in sum over "
          f"{len(tree.levels) - 1} levels on {name_power}", flush=True)

    for name in ("sponge", "verify"):
        check(launches[name] > 0, f"kernel {name} never ran in the main path")

    # (7) K4 against the plain permutation: 65,536 states of full 256-bit
    # values (most >= p), then rows holding every combination of 0, 1,
    # p - 1, p and 2^256 - 1 in the three lanes, a digit d + 2^16 and a
    # digit 0xFFFFFFFF, each read by value.
    n_perm = 65536
    edges_int = [0, 1, constants.P - 1, constants.P, (1 << 256) - 1]
    combos = list(itertools.product(edges_int, repeat=3))
    odd = digits((2, 3))
    odd[0, 1, 5] += 1 << 16
    odd[1, 0, 0] = 0xFFFFFFFF
    states = torch.cat([
        digits((n_perm, 3)),
        row([v for c in combos for v in c]).reshape(len(combos), 3, fr.NDIGITS),
        odd,
    ])
    plain_perm = poseidon.permutation(states)
    k4_err = max_abs_err(pc.permutation_cuda(states), plain_perm)
    check(k4_err == 0, f"K4 disagrees with the plain permutation (max err {k4_err})")
    perm_limbs = fr.digits_to_limbs(states[:n_perm]).contiguous()
    k4_ms = cuda_time_ms(lambda: pc.permutation_limbs(perm_limbs))
    k4_plain_ms = cuda_time_ms(lambda: poseidon.permutation(states[:n_perm]),
                               iters=1, warmup=0)
    print(f"phase 7 permutation: {states.shape[0]} states (edge rows "
          f"included) K4 = plain; K4 {k4_ms:.3f} ms, plain {k4_plain_ms:.3f} ms "
          f"at {n_perm} states on {name_power}", flush=True)

    pc.reset_launch_counts()

    # (8) The engines and the packed entry points.
    check(engine.verify_engines_match(batch=4096, device=dev),
          "verify_engines_match(4096) failed")
    cuda_engine = engine.CudaPoseidonEngine(dev)
    check(torch.equal(cuda_engine.batch_permutation(states[:n_perm]),
                      plain_perm[:n_perm]),
          "CudaPoseidonEngine.batch_permutation disagrees with plain")
    x, y = digits((n_perm,)), digits((n_perm,))
    check(torch.equal(pc.hash_single_cuda_packed(fr.pack16(x)),
                      pc.hash_single_cuda(x)), "packed single")
    check(torch.equal(pc.hash_pair_cuda_packed(fr.pack16(x), fr.pack16(y)),
                      pc.hash_pair_cuda(x, y)), "packed pair")
    for w in (2, 5, 9):
        g = digits((n_perm, w))
        check(torch.equal(pc.hash_multiple_cuda_packed(fr.pack16(g)),
                          pc.hash_multiple_cuda(g)), f"packed multiple w={w}")
    optimal = cuda_engine.get_optimal_batch_size()
    print(f"phase 8 engines: verify_engines_match(4096) true, engine "
          f"permutation of {n_perm} states = plain, packed = unpacked at "
          f"batch {n_perm} (multiple at widths 2, 5, 9); "
          f"get_optimal_batch_size() = {optimal}", flush=True)

    # (9) The benchmark suite: its gate, then the reference's configs; each
    # config's last output is held against the plain sponge on the card.
    check(bench_run.verify_paths_match(device=dev), "verify_paths_match failed")
    rates = {}
    for batch, total, label in bench_run.POSEIDON_CONFIGS:
        for mode in ("pairs", "single"):
            res = bench_run.bench_poseidon(batch, total, mode, device=dev)
            check(res["bit_exact"] and res["pipelined"] == (batch <= 2048),
                  f"{label} {mode}")
            rates[f"{label} {mode}"] = res["hashes_per_s"]
            print(f"phase 9 {label} ({batch} x {total}) {mode}"
                  f"{' coalesced' if res['pipelined'] else ' sync'}: "
                  f"{res['hashes_per_s']:.0f} hashes/s on {name_power}",
                  flush=True)

    class PackedSpy(engine.CudaPoseidonEngine):
        packed_calls = 0

        def batch_hash_single_packed(self, xp):
            self.packed_calls += 1
            return super().batch_hash_single_packed(xp)

    spy = PackedSpy(dev)
    coalescing = engine.CoalescingPoseidonEngine(spy)
    host = digits((512,)).cpu().numpy().astype(np.uint32)
    host[2, 3] = (1 << 16) + 7  # a digit >= 2^16 must not alias
    got = coalescing.async_hash_single(host).get()
    check(spy.packed_calls == 0, "a non-canonical flush took the packed wire")
    check(torch.equal(got, cuda_engine.batch_hash_single(host)),
          "full-width flush disagrees with the CUDA engine")
    host[2, 3] = 7
    got = coalescing.async_hash_single(host).get()
    check(spy.packed_calls == 1 and torch.equal(
        got, cuda_engine.batch_hash_single(host)), "packed flush")
    slice2 = dict(pc.launch_counts)
    print(f"phase 9 coalescing gate: digit 2^16 + 7 took the full-width path "
          f"= direct engine; slice-2 launches {slice2}", flush=True)
    for name in ("permutation", "sponge"):
        check(slice2[name] > 0, f"kernel {name} never ran in the slice-2 path")

    # Slice 3: the deduplicated verify, updates, batch trees and save/load.
    # Each main-path call runs with the launch counts set to 0 just before
    # it and must make exactly the launches of its route; those add up to
    # the slice's counts.  The comparisons with K3 or the plain version and
    # the timing loops run between such calls, so they count nowhere.
    slice3 = dict.fromkeys(pc.launch_counts, 0)

    def main_path(what, fn, sponge, verify):
        pc.reset_launch_counts()
        out = fn()
        got = dict(pc.launch_counts)
        want = dict.fromkeys(got, 0)
        want.update(sponge=sponge, verify=verify)
        check(got == want, f"{what}: launches {got}, want {want}")
        for name, n in got.items():
            slice3[name] += n
        return out

    def k3_verdicts(p, s, l, r, a=arity):
        return merkle.verify_proofs(
            torch.as_tensor(p, device=dev), fr.as_digits(s, device=dev),
            fr.as_digits(l, device=dev), fr.as_digits(r, device=dev), a,
        ).cpu().numpy()

    def wall_ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / iters * 1e3

    def host(p, s, l, r):
        return (p.cpu().numpy(), s.cpu().numpy().astype(np.uint32),
                l.cpu().numpy().astype(np.uint32),
                r.cpu().numpy().astype(np.uint32))

    # (10) Phase 6's 5,000 proofs of the 50K tree, on the host as a verifier
    # gets them, through verify_each's dedup path; tampered copies.  The
    # dedup route is one K1 launch per proof level (h of them) and one K3
    # launch when a check marks suspects; a declined batch is one K3 launch.
    h = pos.shape[1]
    pos_h, sib_h, proved_h, root_h = host(pos, sib, proved, root)
    each = main_path("5K honest", lambda: merkle.verify_each(
        pos_h, sib_h, proved_h, root_h, arity, device=dev), h, 0)
    check(bool(each.all()) and np.array_equal(
        each, k3_verdicts(pos_h, sib_h, proved_h, root_h)),
        "dedup verify of 5,000 valid proofs")
    # Proof 11 becomes a copy of proof 10, so the two share their suffix
    # and tampering 10's leaf must fail an edge check: a suspect for K3.
    lv_t, sib_t, pos_t = proved_h.copy(), sib_h.copy(), pos_h.copy()
    lv_t[11], sib_t[11], pos_t[11] = lv_t[10], sib_t[10], pos_t[10]
    lv_t[10, 0] ^= 1
    sib_t[20, 3, 1, 5] ^= 1
    pos_t[30, 2] = (pos_t[30, 2] + 1) % arity
    got = main_path("5K tampered", lambda: merkle.verify_each(
        pos_t, sib_t, lv_t, root_h, arity, device=dev), h, 1)
    check(np.flatnonzero(~got).tolist() == [10, 20, 30] and np.array_equal(
        got, k3_verdicts(pos_t, sib_t, lv_t, root_h)),
        "dedup isolation: exactly proofs 10, 20, 30 false, = K3")
    root_t = root_h.copy()
    root_t[0] ^= 1
    got = main_path("5K root tampered", lambda: merkle.verify_each(
        pos_h, sib_h, proved_h, root_t, arity, device=dev), h, 0)
    check(not got.any() and np.array_equal(
        got, k3_verdicts(pos_h, sib_h, proved_h, root_t)), "tampered root")
    sib_d = sib_h.copy()
    sib_d[40, 0, 0, 2] += 1 << 16  # packs to the valid digit
    check(merkle._dedup_pack(pos_h, sib_d, proved_h, root_h, arity) is None,
          "digit d + 2^16 must take the declined path")
    got = main_path("5K declined", lambda: merkle.verify_each(
        pos_h, sib_d, proved_h, root_h, arity, device=dev), 0, 1)
    check(np.flatnonzero(~got).tolist() == [40] and np.array_equal(
        got, k3_verdicts(pos_h, sib_d, proved_h, root_h)),
        "declined batch: exactly proof 40 false, = K3")
    # The tree method on proofs already on the card: one K3 launch where
    # they lie, no host round trip, against a direct K3 call.
    check(main_path("5K tree method", lambda: tree.verify_batch_proofs(
        pos, sib, proved), 0, 1), "verify_batch_proofs of 5,000 proofs")
    dedup_5k_ms = wall_ms(lambda: merkle.verify_each(
        pos_h, sib_h, proved_h, root_h, arity, device=dev))
    exact_5k_ms = wall_ms(lambda: merkle.verify_each(
        pos_h, sib_h, proved_h, root_h, arity, dedupe=False, device=dev))
    tree_5k_ms = wall_ms(lambda: tree.verify_batch_proofs(pos, sib, proved))
    k3_card_5k_ms = wall_ms(lambda: bool(merkle.verify_proofs(
        pos, sib, proved, root, arity).all()))
    print(f"phase 10 dedup verify: 5,000 proofs of the 50K tree = K3 (valid; "
          f"leaf/sibling/position tampered -> exactly 10/20/30 false; root "
          f"tampered -> all false; digit d + 2^16 declined -> 40 false); "
          f"from host proofs: dedup {dedup_5k_ms:.3f} ms, K3 "
          f"{exact_5k_ms:.3f} ms; proofs on the card: verify_batch_proofs "
          f"{tree_5k_ms:.3f} ms, K3 {k3_card_5k_ms:.3f} ms on {name_power}",
          flush=True)

    # (11) The device program against its plain version on the CPU: the
    # reference's 5,000 proofs of a 1,024-leaf arity-4 tree, honest and
    # with one tampered leaf (so the mask is not all false; the leaf's four
    # other proofs share its suffix, so it is a suspect for K3).
    small = merkle.NaryMerkleTree(digits((1024,)), cfg, device=dev)
    idx11 = torch.as_tensor(np.arange(5000) % 1024, device=dev)
    p11, s11 = small.generate_batch_proofs(idx11)
    p11, s11, l11, r11 = host(p11, s11, small.levels[0][idx11],
                              small.get_root_hash())
    l11_bad = l11.copy()
    l11_bad[123, 7] ^= 1
    cpu = torch.device("cpu")
    prog_err = 0
    for lv11, want_flags, n_k3 in ((l11, [True, True], 0),
                                   (l11_bad, [False, True], 1)):
        wire = merkle._dedup_pack(p11, s11, lv11, r11, arity)
        check(wire is not None, "5K x 1024 wire")
        run_on = lambda d, w=wire: merkle._dedup_verify_levels(  # noqa: E731
            arity, w.sizes, w.kb, w.tb, w.lm16, merkle._upload(w.packed, d))
        flags_card, bad_card = run_on(dev)
        flags_cpu, bad_cpu = run_on(cpu)
        prog_err = max(prog_err, max_abs_err(flags_card.cpu(), flags_cpu),
                       max_abs_err(bad_card.cpu(), bad_cpu))
        check(flags_cpu.tolist() == want_flags, f"plain flags {want_flags}")
        got = main_path("5K x 1024", lambda: merkle.verify_each(
            p11, s11, lv11, r11, arity, device=dev), p11.shape[1], n_k3)
        check(np.array_equal(got, k3_verdicts(p11, s11, lv11, r11)),
              "5K x 1024 dedup = K3")
    check(prog_err == 0, "device program disagrees with its plain version")
    packed11 = merkle._upload(wire.packed, dev)
    prog_ms = cuda_time_ms(lambda: merkle._dedup_verify_levels(
        arity, wire.sizes, wire.kb, wire.tb, wire.lm16, packed11))
    t = time.perf_counter()
    run_on(cpu)
    prog_plain_ms = (time.perf_counter() - t) * 1e3
    print(f"phase 11 device program: 5,000 proofs x 1,024 leaves, flags and "
          f"mask = plain (CPU) on the honest and a tampered wire "
          f"({len(wire.packed) * 4} B, jobs {list(wire.sizes)}); program "
          f"{prog_ms:.3f} ms on {name_power}, plain {prog_plain_ms:.3f} ms "
          f"on the host CPU", flush=True)

    # (12) 50,000 proofs of a 50,000-leaf tree, one tampered: isolation
    # flags exactly it (= K3); isolated, honest and full per-proof times
    # (the benchmark's own timing loops, outside the counts).  Then the
    # tree method on 50,000 proofs of phase 5's tree already on the card.
    iso = bench_run.bench_batch_verify_tampered(n_leaves, n_leaves, arity,
                                                iters=3, device=dev)
    check(iso["flagged"] == [25000], f"50K isolation flagged {iso['flagged']}")
    idx12 = torch.as_tensor(
        np.random.default_rng(12).integers(0, n_leaves, n_leaves), device=dev)
    pos12, sib12 = tree.generate_batch_proofs(idx12)
    proved12 = tree.levels[0][idx12]
    check(main_path("50K tree method", lambda: tree.verify_batch_proofs(
        pos12, sib12, proved12), 0, 1), "verify_batch_proofs of 50,000 proofs")
    tree_50k_ms = wall_ms(lambda: tree.verify_batch_proofs(
        pos12, sib12, proved12), 3)
    k3_card_50k_ms = wall_ms(lambda: bool(merkle.verify_proofs(
        pos12, sib12, proved12, root, arity).all()), 3)
    print(f"phase 12 isolation: 1 of 50,000 tampered -> flagged [25000] = K3; "
          f"isolated {iso['isolated_ms']:.3f} ms, honest dedup "
          f"{iso['honest_ms']:.3f} ms, full K3 {iso['full_exact_ms']:.3f} ms "
          f"(means of 3, host proofs); proofs on the card: "
          f"verify_batch_proofs {tree_50k_ms:.3f} ms, K3 "
          f"{k3_card_50k_ms:.3f} ms on {name_power}", flush=True)

    # (13) Updates, insert, batch trees and save/load on the 50K tree: one
    # K1 launch per level above the leaves.
    uidx = np.random.default_rng(13).choice(n_leaves, 64, replace=False)
    uvals = digits((64,))
    upd = merkle.NaryMerkleTree.from_levels(tree.levels, arity, n_leaves,
                                            device=dev)
    check(main_path("64 updates", lambda: upd.update_leaves(uidx, uvals),
                    h, 0), "update_leaves")
    new_leaves = leaves.clone()
    new_leaves[torch.as_tensor(uidx, device=dev)] = uvals
    rebuilt = merkle.build_tree_levels(new_leaves, arity)
    check(all(torch.equal(a, b) for a, b in zip(upd.levels, rebuilt))
          and len(upd.levels) == len(rebuilt), "64 updates = rebuild")
    check(tree.root_int() == ROOT_50K_ARITY4, "the updated tree's input moved")
    update_ms = wall_ms(lambda: merkle.update_tree_levels(
        tree.levels, arity, uidx, uvals))
    rebuild_ms = wall_ms(lambda: merkle.build_tree_levels(new_leaves, arity))
    extra = digits((1,))
    check(main_path("insert", lambda: upd.insert_leaf(extra[0]), h, 0)
          and upd.get_leaf_count() == n_leaves + 1, "insert_leaf")
    want = merkle.build_tree_levels(torch.cat([new_leaves, extra]), arity)
    check(all(torch.equal(a, b) for a, b in zip(upd.levels, want)),
          "insert into a padded slot = rebuild")
    sets = [digits((4096,)) for _ in range(16)]
    batch_trees = main_path(
        "batch trees", lambda: merkle.build_batch_trees(sets, arity),
        merkle.tree_height(4096, arity) - 1, 0)
    singles = [merkle.merkle_root(s, arity) for s in sets]
    check(all(torch.equal(t.get_root_hash(), r)
              for t, r in zip(batch_trees, singles)),
          "batch trees = 16 single-tree roots")
    batch_ms = wall_ms(lambda: merkle.build_batch_trees(sets, arity), 3)
    singles_ms = wall_ms(lambda: [merkle.build_tree_levels(s, arity)
                                  for s in sets], 3)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tree.npz")
        merkle.save_tree(tree, path)
        loaded = main_path("load_tree(verify=True)", lambda: merkle.load_tree(
            path, verify=True, device=dev), h, 0)
    check(merkle.compare_trees(tree, loaded) and all(
        torch.equal(a, b) for a, b in zip(tree.levels, loaded.levels)),
        "save_tree -> load_tree(verify=True)")
    print(f"phase 13 updates: 64 updates = rebuild ({update_ms:.3f} ms vs "
          f"rebuild {rebuild_ms:.3f} ms), insert into a padded slot = "
          f"rebuild; 16 x 4,096 batch trees = single roots ({batch_ms:.3f} "
          f"ms vs {singles_ms:.3f} ms one by one); save/load(verify=True) "
          f"round trip of the 50K tree; slice-3 launches {slice3} on "
          f"{name_power}", flush=True)
    for name in ("sponge", "verify"):
        check(slice3[name] > 0, f"kernel {name} never ran in the slice-3 path")

    # (14) Latency sweep: each kernel at the shapes the slices launch it
    # with, under every G, beside the automatic choice.
    sweep = {}

    def sweep_point(label, fn, batch, kernel):
        times = {g: cuda_time_ms(lambda g=g: fn(g), iters=3, warmup=1)
                 for g in pc.LANES}
        auto = pc.choose_lanes(batch, pc.resident_states(dev, kernel))
        sweep[label] = {"ms": {str(g): t for g, t in times.items()},
                        "auto_lanes": auto,
                        "best_lanes": min(times, key=times.get)}
        print(f"phase 14 sweep {label}: " + ", ".join(
            f"G={g} {t:.3f} ms" for g, t in times.items())
            + f"; auto G={auto} on {name_power}", flush=True)

    for n_groups in (64, 1024, 16384, 65536):
        x4 = fr.digits_to_limbs(digits((n_groups, 4))).contiguous()
        sweep_point(f"K1 arity-4 x {n_groups}", lambda g, x=x4: pc.sponge_limbs(
            x, poseidon.DS_MULTIPLE, lanes=g), n_groups, "sponge")
    for n_pairs in (4096, 65536, 262144):
        x2 = fr.digits_to_limbs(digits((n_pairs, 2))).contiguous()
        sweep_point(f"K1 pairs x {n_pairs}", lambda g, x=x2: pc.sponge_limbs(
            x, poseidon.DS_PAIR, lanes=g), n_pairs, "sponge")
    for n_k in (500, 5000, 50000):
        idx14 = torch.as_tensor(
            np.random.default_rng(14).integers(0, n_leaves, n_k), device=dev)
        p14, s14 = tree.generate_batch_proofs(idx14)
        a14 = (p14.contiguous(), fr.digits_to_limbs(s14).contiguous(),
               fr.digits_to_limbs(tree.levels[0][idx14]).contiguous(),
               fr.digits_to_limbs(root).contiguous())
        sweep_point(f"K3 {n_k} x 8 levels", lambda g, a=a14: pc.verify_limbs(
            *a, arity, lanes=g), n_k, "verify")
    resident = {k: pc.resident_states(dev, k) for k in ("sponge", "verify")}
    print(f"phase 14 resident states at G = 1: {resident}", flush=True)

    k1_bound, k1_by = bound(65536, 65536 * 3 * 32)
    k3_perms = n_proofs * h * ((arity + 1) // 2)
    k3_bound, k3_by = bound(k3_perms, pos.numel() * 4 + sib.numel() * 2
                            + proved.numel() * 2 + 32 + n_proofs)
    k4_bound, k4_by = bound(n_perm, n_perm * 6 * 32)
    k1_lanes = pc.choose_lanes(65536, resident["sponge"])
    record = {"kernels": [
        {"name": "sponge", "route": "cuda",
         "source": "cuzk_tpu_torch/csrc/poseidon_kernels.cu",
         "replaces": "cuzk_tpu/ops/poseidon_pallas.py:488",
         "launches": launches["sponge"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "share": k1_bound / k1_ms, "lanes": k1_lanes,
         "library_ms": None},
        {"name": "verify", "route": "cuda",
         "source": "cuzk_tpu_torch/csrc/poseidon_kernels.cu",
         "replaces": "cuzk_tpu/ops/poseidon_pallas.py:385",
         "launches": launches["verify"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "share": k3_bound / k3_ms, "lanes": k3_lanes,
         "library_ms": None},
        {"name": "permutation", "route": "cuda",
         "source": "cuzk_tpu_torch/csrc/poseidon_kernels.cu",
         "replaces": "cuzk_tpu/ops/poseidon_pallas.py:795",
         "launches": slice2["permutation"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
         "bound_by": k4_by, "share": k4_bound / k4_ms, "lanes": 1,
         "library_ms": None},
    ], "pair_hashes_per_s": head["value"], "build_50k_ms": build_ms,
        "verify_5k_ms": verify_ms, "slice2_sponge_launches": slice2["sponge"],
        "poseidon_configs_hashes_per_s": rates,
        "optimal_batch_size": optimal,
        "slice3_sponge_launches": slice3["sponge"],
        "slice3_verify_launches": slice3["verify"],
        "dedup_verify_5k_ms": dedup_5k_ms, "k3_verify_5k_host_ms": exact_5k_ms,
        "tree_verify_5k_card_ms": tree_5k_ms, "k3_verify_5k_card_ms": k3_card_5k_ms,
        "tree_verify_50k_card_ms": tree_50k_ms,
        "k3_verify_50k_card_ms": k3_card_50k_ms,
        "dedup_program_5k_x_1024_ms": prog_ms,
        "dedup_program_plain_cpu_ms": prog_plain_ms,
        "isolated_50k_ms": iso["isolated_ms"],
        "dedup_honest_50k_ms": iso["honest_ms"],
        "k3_full_50k_ms": iso["full_exact_ms"],
        "update_64_ms": update_ms, "rebuild_50k_ms": rebuild_ms,
        "batch_trees_16x4096_ms": batch_ms, "single_trees_16x4096_ms": singles_ms,
        "build_50k_k1_ms": build_k1_ms, "sweep": sweep,
        "resident_states": resident, "clocks_max_sm_mhz": clock_hz / 1e6,
        "ptxas": kernels.ptxas, "card": name_power}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
