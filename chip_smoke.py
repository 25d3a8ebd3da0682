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
  holding one state element each, ten states a warp) against their plain
  versions at edge batches, and a latency sweep of each kernel under each
  G beside the automatic choice, across the split's capacity at one warp
  a scheduler (SMs x 4 x 10 states).  Phase 1 prints ptxas's record
  of every kernel (registers, stack frame, spills) and fails if the
  library builds another set of kernels than the pinned one, if a
  kernel's registers move, or if a kernel uses local memory;
- slice 5 (phase 15): the 1,048,576-leaf arity-8 tree (padded to 8^7 =
  2,097,152 rows, 7 K1 launches) built on the card, K1 at each of those
  launches' shapes and every level of the tree held against the plain
  sponge, and K3 on 5,000 of its proofs (7 levels at arity 8; one with its
  leaf, one with a sibling and one with a position tampered) against the
  plain verify under every G; then built sharded
  (``parallel.distributed``) by 1 rank and by 4 ranks that share the card,
  each rank a fresh interpreter of this file (``--sharded-rank``) started
  by ``bench.mp_scaling.launch``: every rank's root and levels (by SHA-256
  of each block) equal to the single-card build's, 5,000 sharded proofs
  equal to ``merkle.generate_proofs`` and verified by one K3 launch (its
  verdicts on the tampered proofs equal to the plain verify's), and
  1,048,576 sharded pair hashes equal to ``hash_pair_cuda`` on the whole
  batch.  Ranks sharing one card are time-sliced: their times are an
  overhead reading, not a speed-up;
- slice 6 (phase 16, and ``sub`` in phase 2): ``bench.run``'s ``verify``
  suite with ``--stress`` (the port's oracle, its native oracle, the plain
  path and the kernels on 256 random inputs, the golden vectors, builds
  against the native oracle, K3 and the dedup verify, the 262,144-leaf
  arity-8 tier), ``compare`` at 50,000 leaves arity 4 (K1's build against
  the plain build under ``merkle.engine_path("plain")`` on the card) and
  ``sweep`` (arities 2-8 x 64-4,096 leaves, 256 honest proofs a verify
  that must all pass), each failing on a mismatch;
  ``BatchFieldArithmetic`` on phase 2's 68,613
  operands per op against the plain ``fr`` ops on the card; the int
  helpers against the golden values; the port's native oracle against its
  Python-int oracle on 256 pairs.

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
trees), the slice-4 sweep, the slice-5 times (``build_1m_arity8_ms``; its K1
sum with the bound of those 7 launches, the share reached and the plain
sponge's time; K3 at the 1M tree's 5,000 proofs likewise,
``verify_1m_5k_*``; ``sharded_build_1m_ms`` per rank count with stages and
backend, ``sharded_proofs_5k_ms``), the slice-6 numbers
(``verify_suite_ok``, ``compare_50k_ms`` accelerated and plain,
``sweep_ms`` per arity, ``fr_sub_ms`` with its plain time and bound) and the
ptxas record.  Each kernel's ``launches``
is the sum over the slices' main-path runs (``launches_by_slice`` splits
it; slice 5's counts add every rank's).  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

There is no CPU fallback: without a CUDA device the script exits 1 before
printing any result.  It imports neither jax nor the JAX package: the
kernels are held against the port's plain versions on the card, and the
answers against the golden values below, which
``tests/test_torch_package.py`` holds against ``cuzk_tpu.oracle`` and
``cuzk_tpu.native``.
"""

import hashlib
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
# Root of generate_test_leaves(262144, 42) at arity 8: node 0 of level 6 of
# the tree of generate_test_leaves(1048576, 42), whose first 8^6 leaves
# those are.
ROOT_262144_ARITY8 = 0x1232000CF94C4A090CBEA211DA7690E468A0CCA7EC6A799FDEFC83B686828A56
# Slice 5: the largest published build, its proofs and the sharded hashes.
LEAVES_1M, ARITY_1M, PROOFS_1M, PAIRS_1M = 1_048_576, 8, 5_000, 1_048_576
SHARDED_RANKS = (1, 4)
TAMPERED_1M = (17, 1234, 4321)  # leaf, sibling, position


# The registers of every kernel the library builds, as they compile with nvcc
# 12.9 for sm_90a: K1 in both input forms and K3 at G = 1 (the one-thread
# core K4 runs) and G = 3 (the element split), K4, and the check kernel at
# its two row widths (reduce_wide's 32 digits, else 16).
KERNEL_PTXAS = {
    "sponge_kernel<1>": 80, "sponge_kernel<3>": 76,
    "sponge_digits_kernel<1>": 80, "sponge_digits_kernel<3>": 76,
    "verify_digits_kernel<1>": 88, "verify_digits_kernel<3>": 80,
    "permutation_digits_kernel": 78,
    "fr_op_digits_kernel<16>": 80, "fr_op_digits_kernel<32>": 78,
}
# Phase 7's K4 sweep (states a launch) and the batch field op's shapes:
# phase 2's operand count and one launch that fills the card many times.
K4_SWEEP = (4096, 16384, 65536, 262144, 1048576)
FR_SUB_LARGE = 4_194_304
# S-boxes a permutation: 8 full rounds of three, 56 partial rounds of one.
SBOXES_PER_PERMUTATION = 80


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes: two processes compare blocks by it."""
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def proof_indices() -> np.ndarray:
    return np.random.default_rng(42).integers(0, LEAVES_1M, PROOFS_1M)


def pair_inputs():
    rng = np.random.default_rng(7)
    return tuple(rng.integers(0, 1 << 16, (PAIRS_1M, 16), dtype=np.uint32)
                 for _ in range(2))


def tamper_1m(pos, sib, proved):
    """Phase 15's proofs with proof 17's leaf, a sibling of proof 1234 and
    a position of proof 4321 changed: exactly :data:`TAMPERED_1M` must
    fail."""
    pos, sib, proved = pos.clone(), sib.clone(), proved.clone()
    proved[TAMPERED_1M[0], 0] ^= 1
    sib[TAMPERED_1M[1], 3, 5, 7] ^= 1
    pos[TAMPERED_1M[2], 6] = (pos[TAMPERED_1M[2], 6] + 1) % ARITY_1M
    return pos, sib, proved


def sass_instructions(library: str, kernel: str):
    """``(counts, loops)`` of ``kernel`` in ``library``'s SASS
    (``cuobjdump -sass``, from the toolkit that built it): one
    ``(address, opcode)`` per instruction, and the ``(start, end)``
    addresses of each backward branch's loop.  None without cuobjdump."""
    import re
    import shutil

    from cuzk_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
        if tool is None:
            return None
    sass = subprocess.run([tool, "-sass", library], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        if not re.search(rf"\d{kernel}E", name):
            continue
        pat = r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);"
        insts = [(int(a, 16), op, rest) for a, op, rest in re.findall(pat, body)]
        loops = [(int(m.group(1), 16), addr) for addr, op, rest in insts
                 if op == "BRA" for m in [re.search(r"0x([0-9a-f]+)", rest)]
                 if m and int(m.group(1), 16) < addr]
        return [(a, op) for a, op, _ in insts], loops
    raise SmokeFailure(f"{kernel} not found in the SASS of {library}")


def k4_dynamic_counts(insts, loops):
    """SASS instructions one permutation of K4 issues, by opcode class.
    permute_rounds_ilp is two loops: the rounds (64 trips) and, inside,
    the S-box (3 trips in a full round, 1 in a partial one: 80 in all).
    The instructions outside both run once; branches inside a loop body are
    counted as taken in full (the mh != 0 fold runs on all but tiny
    products)."""
    if len(loops) != 2:
        raise SmokeFailure(f"K4's SASS has {len(loops)} loops, not 2: {loops}")
    (s0, e0), (s1, e1) = sorted(loops, key=lambda l: l[1] - l[0])
    inner = lambda a: s0 <= a <= e0  # noqa: E731
    outer = lambda a: s1 <= a <= e1  # noqa: E731

    def cls(op):
        for c in ("IMAD.WIDE", "IMAD.HI", "IMAD.X", "IMAD", "IADD3", "SEL",
                  "LDC"):
            if op.startswith(c) or (c == "LDC" and op.startswith("ULDC")):
                return c
        return "other"

    from cuzk_tpu_torch import constants

    counts = {}
    for addr, op in insts:
        trips = (SBOXES_PER_PERMUTATION if inner(addr)
                 else constants.TOTAL_ROUNDS if outer(addr) else 1)
        counts[cls(op)] = counts.get(cls(op), 0) + trips
    static = {"kernel": len(insts),
              "sbox_loop": sum(inner(a) for a, _ in insts),
              "round_loop": sum(outer(a) for a, _ in insts)}
    return counts, static


def sharded_rank(argv) -> None:
    """One rank of phase 15: ``--sharded-rank <ranks> <rank> <dir>``.
    Joins the process group on the card, runs the sharded build, proofs
    and pair hashes of the 1M-leaf arity-8 tree and prints one ``RESULT``
    line of digests, times and launch counts.  Any failure raises."""
    ranks, rank = int(argv[0]), int(argv[1])
    from cuzk_tpu_torch import merkle
    from cuzk_tpu_torch.bench import mp_scaling
    from cuzk_tpu_torch.field import fr
    from cuzk_tpu_torch.ops import poseidon_cuda as pc
    from cuzk_tpu_torch.parallel import distributed

    mesh = mp_scaling.join_mesh(os.path.join(argv[2], f"store{ranks}"),
                                ranks, rank)
    dev = mesh.device
    leaves = np.load(os.path.join(argv[2], "leaves.npy"))
    idx = proof_indices()
    proved = fr.as_digits(leaves[idx], device=dev)
    left, right = pair_inputs()

    def wall_ms(fn, iters=3):
        fn()
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        for _ in range(iters):
            fn()
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t) / iters * 1e3

    timing = mp_scaling.time_build(leaves, ARITY_1M, mesh, iters=3)

    # The main path, counted alone: build, proofs, one K3 launch, hashes.
    pc.reset_launch_counts()
    sharded, replicated = distributed.sharded_build_levels(leaves, ARITY_1M, mesh)
    build_launches = pc.launch_counts["sponge"]
    pos, sib = distributed.sharded_generate_proofs(sharded, replicated,
                                                   ARITY_1M, idx, mesh)
    root = replicated[-1][0]
    ok = merkle.verify_proofs(pos, sib, proved, root, ARITY_1M)
    pairs = distributed.sharded_hash_pairs(left, right, mesh)
    torch.cuda.synchronize(dev)
    counts = dict(pc.launch_counts)

    check(bool(ok.all()), f"rank {rank}: sharded proofs failed to verify")
    verdicts = merkle.verify_proofs(*tamper_1m(pos, sib, proved), root, ARITY_1M)
    flipped = torch.nonzero(~verdicts).flatten().tolist()
    check(flipped == sorted(TAMPERED_1M),
          f"rank {rank}: tampered {TAMPERED_1M} flipped {flipped}")
    proofs_ms = wall_ms(lambda: distributed.sharded_generate_proofs(
        sharded, replicated, ARITY_1M, idx, mesh))
    pairs_ms = wall_ms(lambda: distributed.sharded_hash_pairs(left, right, mesh))
    print("RESULT " + json.dumps({
        "rank": rank, "backend": mesh.backend, "shared_card": mesh.shared_card,
        "build_ms": timing["build_ms"], "stages": timing["stages"],
        "sponge_launches_per_build": timing["sponge_launches_per_build"],
        "build_launches": build_launches, "launches": counts,
        "root": fr.array_to_ints(root)[0],
        "sharded": [digest(lv) for lv in sharded],
        "replicated": [digest(lv) for lv in replicated],
        "pos": digest(pos), "sib": digest(sib), "pairs": digest(pairs),
        "verdicts": digest(verdicts.to(torch.uint8)),
        "proofs_ms": proofs_ms, "pairs_ms": pairs_ms,
    }), flush=True)
    torch.distributed.destroy_process_group()


def sharded_phase(dev, name_power, bound):
    """Phase 15: the 1M-leaf arity-8 build on the card, every level of it
    held against the plain sponge and K3 on its proofs against the plain
    verify; then the sharded build, proofs and pair hashes at each of
    :data:`SHARDED_RANKS`, every rank held against the single-card
    results.  ``bound(permutations, nbytes)`` is the card's bound.  Returns
    the phase's launch counts (this process's and every rank's main-path
    runs), its numbers for the JSON line, and K1's and K3's largest
    differences from their plain versions."""
    from cuzk_tpu_torch import merkle, poseidon
    from cuzk_tpu_torch.bench import mp_scaling
    from cuzk_tpu_torch.bench import run as bench_run
    from cuzk_tpu_torch.field import fr
    from cuzk_tpu_torch.ops import poseidon_cuda as pc
    from cuzk_tpu_torch.parallel import distributed
    from cuzk_tpu_torch.utils.stats import cuda_time_ms

    check(bench_run.NORTH_STAR_BUILD == (LEAVES_1M, ARITY_1M), "1M config")
    leaves_1m = merkle.generate_test_leaves(LEAVES_1M, 42)
    leaves_1m_dev = leaves_1m.to(dev)
    merkle.build_tree_levels(leaves_1m_dev, ARITY_1M)  # warm
    torch.cuda.synchronize()
    pc.reset_launch_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    levels_1m = merkle.build_tree_levels(leaves_1m_dev, ARITY_1M)
    end.record()
    end.synchronize()
    build_1m_ms = start.elapsed_time(end)
    slice5 = dict(pc.launch_counts)
    h_1m = len(levels_1m) - 1
    check(slice5["sponge"] == h_1m == 7 and levels_1m[0].shape[0] == 8 ** 7,
          f"1M build: launches {slice5}, {h_1m} levels")
    check(fr.array_to_ints(levels_1m[-2][0])[0] == ROOT_262144_ARITY8,
          "node 0 of level 6 of the 1M tree != the 262,144-leaf root")
    root_1m = fr.array_to_ints(levels_1m[-1][0])[0]

    # K1 at each of the build's 7 shapes (262,144 down to 1 group of 8)
    # against the plain sponge on the same rows, and the build's own next
    # level against it too: every level up to the root is held by the plain
    # version.  The plain sponge runs in pieces of 65,536 groups.
    build_1m_k1_ms = build_1m_plain_ms = 0.0
    k1_err = k1_perms = k1_bytes = 0
    for lv, above in zip(levels_1m[:-1], levels_1m[1:]):
        groups = lv.view(-1, ARITY_1M, fr.NDIGITS)
        lv_limbs = fr.digits_to_limbs(lv).contiguous().view(-1, ARITY_1M, fr.NLIMBS)
        build_1m_k1_ms += cuda_time_ms(
            lambda x=lv_limbs: pc.sponge_limbs(x, poseidon.DS_MULTIPLE), iters=3)
        start.record()
        plain = torch.cat([poseidon.hash_multiple(piece)
                           for piece in groups.split(65536)])
        end.record()
        end.synchronize()
        build_1m_plain_ms += start.elapsed_time(end)
        got = fr.limbs_to_digits(pc.sponge_limbs(lv_limbs, poseidon.DS_MULTIPLE))
        k1_err = max(k1_err, max_abs_err(got, plain), max_abs_err(above, plain))
        k1_perms += groups.shape[0] * (ARITY_1M // 2)
        k1_bytes += (lv.shape[0] + groups.shape[0]) * 4 * fr.NLIMBS
        del plain, got, lv_limbs
    check(k1_err == 0, f"K1 disagrees with the plain sponge on the 1M tree's "
          f"levels (max err {k1_err})")
    k1_bound_ms, _ = bound(k1_perms, k1_bytes)
    print(f"phase 15 build: 1,048,576 leaves arity 8 (padded to 8^7) -> root "
          f"{root_1m:#x}, level 6 node 0 golden, K1 and every level = the "
          f"plain sponge at {[lv.shape[0] // ARITY_1M for lv in levels_1m[:-1]]} "
          f"groups; warm build {build_1m_ms:.3f} ms, its 7 K1 launches "
          f"{build_1m_k1_ms:.3f} ms in sum (bound {k1_bound_ms:.3f} ms, share "
          f"{k1_bound_ms / build_1m_k1_ms:.3f}; plain {build_1m_plain_ms:.3f} "
          f"ms) on {name_power}", flush=True)

    # K3 at this slice's shape (5,000 proofs of 7 levels at arity 8: 4,997
    # valid, three tampered), under every G, against the plain verify.
    idx_1m = torch.as_tensor(proof_indices(), device=dev)
    want_pos, want_sib = merkle.generate_proofs(levels_1m, ARITY_1M, idx_1m)
    want_proofs = (digest(want_pos), digest(want_sib))
    proved = levels_1m[0][idx_1m]
    root = levels_1m[-1][0]
    check(want_pos.shape == (PROOFS_1M, h_1m), "1M proofs' shape")
    proofs = tamper_1m(want_pos, want_sib, proved)
    start.record()
    plain_ok = merkle._verify_plain(*proofs, root, ARITY_1M)
    end.record()
    end.synchronize()
    verify_1m_plain_ms = start.elapsed_time(end)
    check(torch.nonzero(~plain_ok).flatten().tolist() == sorted(TAMPERED_1M),
          f"plain verify of the 1M proofs: exactly {TAMPERED_1M} must fail")
    k3_err = max_abs_err(merkle.verify_proofs(*proofs, root, ARITY_1M), plain_ok)
    for g in pc.LANES:
        k3_err = max(k3_err, max_abs_err(
            pc.verify_digits(*proofs, root, ARITY_1M, lanes=g), plain_ok))
    check(k3_err == 0, "K3 disagrees with the plain verify on the 1M proofs")
    want_verdicts = digest(plain_ok.to(torch.uint8))
    verify_1m_ms = cuda_time_ms(
        lambda: merkle.verify_proofs(*proofs, root, ARITY_1M), iters=3)
    k3_bound_ms, _ = bound(
        PROOFS_1M * h_1m * (ARITY_1M // 2),
        want_pos.numel() * 4 + (want_sib.numel() + proved.numel() + 16) * 8
        + PROOFS_1M)
    print(f"phase 15 verify: {PROOFS_1M} proofs x {h_1m} levels arity 8, "
          f"{TAMPERED_1M} tampered (leaf, sibling, position), K3 = plain at "
          f"every G {list(pc.LANES)}; K3 {verify_1m_ms:.3f} ms (bound "
          f"{k3_bound_ms:.3f} ms, share {k3_bound_ms / verify_1m_ms:.3f}; "
          f"plain {verify_1m_plain_ms:.3f} ms) on {name_power}", flush=True)

    # What each rank must report: digests of its blocks of the single-card
    # levels, of the proofs, of the tampered proofs' verdicts (the plain
    # verify's) and of its block of the whole batch's hashes.
    left, right = pair_inputs()
    want_pairs = pc.hash_pair_cuda(fr.as_digits(left, device=dev),
                                   fr.as_digits(right, device=dev))

    def block(t, rank, ranks):
        rows = t.shape[0] // ranks
        return t[rank * rows:(rank + 1) * rows]

    sharded_1m = {}
    with tempfile.TemporaryDirectory() as workdir:
        np.save(os.path.join(workdir, "leaves.npy"),
                leaves_1m.numpy().astype(np.uint32))
        for ranks in SHARDED_RANKS:
            outs = mp_scaling.launch(
                [[sys.executable, os.path.abspath(__file__), "--sharded-rank",
                  str(ranks), str(rank), workdir] for rank in range(ranks)],
                timeout_s=600, env=mp_scaling.worker_env())
            results = [mp_scaling.result_line(out) for out in outs]
            check(all(r is not None for r in results),
                  f"{ranks} ranks: a rank printed no RESULT:\n" + "\n".join(outs))
            backend = distributed.choose_backend(ranks)
            shared = distributed.ranks_share_a_card(ranks)
            for rank, res in enumerate(results):
                who = f"{ranks} ranks, rank {rank}"
                check(res["rank"] == rank and res["backend"] == backend
                      and res["shared_card"] == shared, f"{who}: mesh {res}")
                check(res["root"] == root_1m, f"{who}: root {res['root']:#x}")
                n_sh, n_rep = len(res["sharded"]), len(res["replicated"])
                check(n_sh - 1 + n_rep == len(levels_1m), f"{who}: level count")
                for i, got in enumerate(res["sharded"]):
                    check(got == digest(block(levels_1m[i], rank, ranks)),
                          f"{who}: sharded level {i} differs")
                for i, got in enumerate(res["replicated"]):
                    check(got == digest(levels_1m[n_sh - 1 + i]),
                          f"{who}: replicated level {i} differs")
                check((res["pos"], res["sib"]) == want_proofs,
                      f"{who}: sharded proofs != merkle.generate_proofs")
                check(res["verdicts"] == want_verdicts,
                      f"{who}: K3's verdicts on the tampered proofs != plain")
                check(res["pairs"] == digest(block(want_pairs, rank, ranks)),
                      f"{who}: sharded pair hashes != hash_pair_cuda")
                # Local levels plus the replicated tail, then one K1 launch
                # for this rank's pairs and one K3 launch for the proofs.
                check(res["build_launches"] == h_1m
                      == res["sponge_launches_per_build"] == n_sh - 1 + n_rep - 1,
                      f"{who}: build launches {res['build_launches']}")
                want_counts = dict.fromkeys(res["launches"], 0)
                want_counts.update(sponge=h_1m + 1, verify=1)
                check(res["launches"] == want_counts,
                      f"{who}: launches {res['launches']}, want {want_counts}")
                for name, n in res["launches"].items():
                    slice5[name] += n
            sharded_1m[str(ranks)] = {
                "backend": backend, "shared_card": shared,
                "build_ms": [r["build_ms"] for r in results],
                "stages": results[0]["stages"],
                "local_levels": len(results[0]["sharded"]) - 1,
                "tail_levels": len(results[0]["replicated"]) - 1,
                "sponge_launches_per_build": results[0]["sponge_launches_per_build"],
                "proofs_5k_ms": [r["proofs_ms"] for r in results],
                "hash_pairs_1m_ms": [r["pairs_ms"] for r in results],
            }
            row = sharded_1m[str(ranks)]
            print(f"phase 15 sharded, {ranks} rank(s) on one card ({backend}): "
                  f"roots, {len(levels_1m)} levels, {PROOFS_1M} proofs (K3: all "
                  f"true; tampered: the plain verify's verdicts) and {PAIRS_1M} "
                  f"pair hashes = single card in every rank; build "
                  f"{max(row['build_ms']):.3f} ms (slowest rank; "
                  f"{row['local_levels']} local + {row['tail_levels']} tail K1 "
                  f"launches a rank; main-path launches of every rank "
                  f"{results[0]['launches']}), stages {row['stages']}, proofs "
                  f"{max(row['proofs_5k_ms']):.3f} ms, hashes "
                  f"{max(row['hash_pairs_1m_ms']):.3f} ms on {name_power}",
                  flush=True)
    for name in ("sponge", "verify"):
        check(slice5[name] > 0, f"kernel {name} never ran in the slice-5 path")
    numbers = {
        "build_1m_arity8_ms": build_1m_ms,
        "build_1m_arity8_k1_ms": build_1m_k1_ms,
        "build_1m_arity8_k1_bound_ms": k1_bound_ms,
        "build_1m_arity8_k1_share": k1_bound_ms / build_1m_k1_ms,
        "build_1m_arity8_k1_plain_ms": build_1m_plain_ms,
        "verify_1m_5k_k3_ms": verify_1m_ms,
        "verify_1m_5k_k3_bound_ms": k3_bound_ms,
        "verify_1m_5k_k3_share": k3_bound_ms / verify_1m_ms,
        "verify_1m_5k_plain_ms": verify_1m_plain_ms,
        "sharded_build_1m_ms": sharded_1m,
        "sharded_proofs_5k_ms": max(
            sharded_1m[str(SHARDED_RANKS[-1])]["proofs_5k_ms"]),
    }
    return slice5, numbers, k1_err, k3_err


def slice6_phase(dev, name_power, a, b, sms, clock_hz):
    """Phase 16: the slice-6 main path, counted alone (the verify suite
    with its stress tier, compare at 50,000 leaves arity 4, the sweep,
    ``BatchFieldArithmetic`` on ``a`` and ``b`` (phase 2's operands), the
    int helpers, the native oracle on 256 pairs), then each result held:
    the suites raise on a failed check, the batch ops against the plain
    ``fr`` ops on the card, the helpers against ``GOLDEN``, the native
    oracle against the Python-int one.  Returns the launch counts and the
    numbers for the JSON line."""
    import contextlib
    import io

    from cuzk_tpu_torch import native, oracle, poseidon
    from cuzk_tpu_torch.bench import run as bench_run
    from cuzk_tpu_torch.field import fr
    from cuzk_tpu_torch.field.batch import BatchFieldArithmetic
    from cuzk_tpu_torch.ops import poseidon_cuda as pc
    from cuzk_tpu_torch.utils.stats import cuda_time_ms

    start_s = time.perf_counter()
    int_ops = {"hash_single": poseidon.hash_single_int,
               "hash_pair": poseidon.hash_pair_int,
               "hash_multiple": poseidon.hash_multiple_int}
    batch_ops = [("batch_add", fr.add, (a, b)),
                 ("batch_subtract", fr.sub, (a, b)),
                 ("batch_multiply", fr.mul, (a, b)),
                 ("batch_square", fr.square, (a,)),
                 ("batch_power5", fr.power5, (a,)),
                 ("batch_reduce", fr.red, (a,))]
    rng = np.random.default_rng(16)
    left, right = ([int(v) for v in rng.integers(0, 1 << 63, 256)]
                   for _ in range(2))
    bench_out = io.StringIO()
    suite_s = {}
    pc.reset_launch_counts()
    with tempfile.TemporaryDirectory() as d, \
            contextlib.redirect_stdout(bench_out):
        out = os.path.join(d, "CUDA_VERIFY.json")
        t = time.perf_counter()
        bench_run.main(["--suite", "verify", "--stress", "--skip-verify",
                        "--verify-out", out])
        suite_s["verify"] = time.perf_counter() - t
        with open(out) as f:
            artifact = json.load(f)
        t = time.perf_counter()
        (compare,) = bench_run.main(["--suite", "compare", "--leaves", "50000",
                                     "--arity", "4", "--skip-verify"])
        suite_s["compare"] = time.perf_counter() - t
        t = time.perf_counter()
        sweep_rows = bench_run.main(["--suite", "sweep", "--skip-verify"])
        suite_s["sweep"] = time.perf_counter() - t
    field = BatchFieldArithmetic()
    check(field.initialize(), "BatchFieldArithmetic.initialize")
    batch_got = {m: getattr(field, m)(*args) for m, _, args in batch_ops}
    helpers = [(op, args, want, int_ops[op](*args))
               for op, args, want in GOLDEN if op in int_ops]
    native_pairs = native.batch_hash_pairs(left, right)
    torch.cuda.synchronize()
    slice6 = dict(pc.launch_counts)

    check(artifact["all_ok"] and artifact["stress"]
          and artifact["device"] == name_power
          and len(artifact["checks"]) == 25, f"verify artifact {artifact}")
    check(compare["trees_consistent"], "compare: trees differ")
    verifies = [r for r in sweep_rows if r["suite"] == "batch_verify"]
    builds = [r for r in sweep_rows if r["suite"] == "merkle_build"]
    check(len(builds) == 28 and len(verifies) == 7
          and all(r["all_valid"] for r in verifies), "sweep rows")
    batch_err = 0
    for m, plain, args in batch_ops:
        batch_err = max(batch_err, max_abs_err(batch_got[m], plain(*args)))
    check(batch_err == 0, f"BatchFieldArithmetic != plain fr (err {batch_err})")
    for op, args, want, got in helpers:
        check(got == want, f"{op}_int{args}: {got:#x} != {want:#x}")
    check(native_pairs == [oracle.hash_pair(x, y) for x, y in zip(left, right)],
          "native.batch_hash_pairs != oracle.hash_pair")
    check(slice6["fr_op"] == len(batch_ops), f"fr_op launches {slice6}")
    for name in ("sponge", "verify", "permutation"):
        check(slice6[name] > 0, f"kernel {name} never ran in the slice-6 path")

    # fr_op's sub at phase 2's shape and at FR_SUB_LARGE operands: the check
    # kernel (fr_op_cuda, what BatchFieldArithmetic calls) and the plain
    # fr.sub.  The kernel is bound by its bytes (two operands read, one
    # result written: 128 bytes an element), far above its few hundred
    # integer operations an element at 64 a clock on each SM.
    n = a.shape[0]
    sub_err = max_abs_err(pc.fr_op_cuda("sub", a, b), fr.sub(a, b))
    check(sub_err == 0, "fr_op sub != plain")
    sub_ms = cuda_time_ms(lambda: pc.fr_op_cuda("sub", a, b))
    sub_plain_ms = cuda_time_ms(lambda: fr.sub(a, b), iters=3, warmup=1)

    def bytes_bound_ms(count, row_bytes):
        return max(3 * row_bytes * count / HBM_BYTES_PER_S,
                   25 * count / (sms * 64 * clock_hz)) * 1e3

    sub_bound_ms = bytes_bound_ms(n, 128)
    big = [torch.as_tensor(np.random.default_rng(s).integers(
        0, 1 << 16, (FR_SUB_LARGE, fr.NDIGITS)), device=dev) for s in (161, 162)]
    rows = torch.arange(0, FR_SUB_LARGE, 997, device=dev)
    sub_err = max(sub_err, max_abs_err(pc.fr_op_cuda("sub", *big)[rows],
                                       fr.sub(big[0][rows], big[1][rows])))
    check(sub_err == 0, "fr_op sub != plain at 4,194,304 operands")
    sub_large_ms = cuda_time_ms(lambda: pc.fr_op_cuda("sub", *big), iters=5)
    sub_large_bound_ms = bytes_bound_ms(FR_SUB_LARGE, 128)
    del big
    sweep_ms = {}
    for r in sweep_rows:
        row = sweep_ms.setdefault(str(r["arity"]), {})
        if r["suite"] == "merkle_build":
            row[str(r["leaves"])] = r["build_ms"]
        else:
            row[f"verify_{r['proofs']}_at_{r['leaves']}"] = r["verify_ms"]
    print(f"phase 16 verify suite --stress: {len(artifact['checks'])} checks "
          f"ok ({suite_s['verify']:.1f} s); compare 50,000 leaves arity 4: "
          f"K1 build {compare['accelerated_ms']:.3f} ms, plain build on the "
          f"card {compare['reference_path_ms']:.3f} ms, roots equal "
          f"({suite_s['compare']:.1f} s); sweep: 28 builds, 7 verifies of 256 "
          f"proofs ok ({suite_s['sweep']:.1f} s); BatchFieldArithmetic x 6 "
          f"ops on {n} operands = plain; {len(helpers)} int helpers golden; "
          f"native = oracle on 256 pairs; fr_op sub at {n}: {sub_ms:.4f} ms "
          f"(bound {sub_bound_ms:.4f}), plain {sub_plain_ms:.3f}; at "
          f"{FR_SUB_LARGE}: {sub_large_ms:.3f} ms (bound "
          f"{sub_large_bound_ms:.3f}); slice-6 launches "
          f"{slice6}; phase {time.perf_counter() - start_s:.1f} s on "
          f"{name_power}", flush=True)
    return slice6, {
        "verify_suite_ok": artifact["all_ok"],
        "verify_suite_checks": len(artifact["checks"]),
        "compare_50k_ms": {"accelerated": compare["accelerated_ms"],
                           "plain": compare["reference_path_ms"]},
        "sweep_ms": sweep_ms,
        "fr_sub_ms": sub_ms, "fr_sub_plain_ms": sub_plain_ms,
        "fr_sub_bound_ms": sub_bound_ms,
        "fr_sub_large_ms": sub_large_ms,
        "fr_sub_large_bound_ms": sub_large_bound_ms,
        "fr_sub_err": sub_err,
        "phase16_suite_s": suite_s,
    }


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

    # (1) Build, and ptxas's record of each kernel: the library builds
    # exactly the pinned kernels, each keeping every operand in registers.
    kernels = _build.kernels()
    print(f"phase 1 build: {kernels.build_seconds:.1f} s -> {kernels.path}",
          flush=True)
    for name in sorted(kernels.ptxas):
        rec = kernels.ptxas[name]
        print(f"phase 1 ptxas {name}: {rec}", flush=True)
        check(rec.get("stack_frame") == 0 and rec.get("spill_stores") == 0
              and rec.get("spill_loads") == 0,
              f"{name} uses local memory: {rec}")
    got_ptxas = {name: rec.get("registers")
                 for name, rec in kernels.ptxas.items()}
    check(got_ptxas == KERNEL_PTXAS,
          f"ptxas records moved: {got_ptxas}, expected {KERNEL_PTXAS}")
    print(f"phase 1 ptxas as expected: {got_ptxas} registers, "
          f"0 stack, 0 spills", flush=True)
    kernel_sass = {}
    for name in KERNEL_PTXAS:
        sass = sass_instructions(kernels.path,
                                 name.replace("<", "ILi").replace(">", "E"))
        kernel_sass[name] = None if sass is None else len(sass[0])
    print(f"phase 1 SASS instructions a kernel: {kernel_sass}", flush=True)
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
    for op in ("mul", "square", "power5", "add_wrap_red", "red", "sub"):
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
    # Every op on these operands plus non-canonical rows (d + 2^16,
    # 2^40 - 1, read by value), against the plain op on the canonical digits
    # of the same values (fr.carry).
    na, nb = a.clone(), b.clone()
    na[0, 3] += 1 << 16
    na[1, 15] = (1 << 40) - 1
    nb[2, 0] += 1 << 16
    for op, (_, plain) in pc.FR_OPS.items():
        xa, xb = ((fr.red(fr.carry(na)), fr.red(fr.carry(nb)))
                  if op in ("add_rr", "mul_small_rr") else (na, nb))
        c = 26 if op.startswith("mul_small") else 0
        ca, cb = fr.carry(xa), fr.carry(xb)
        if op == "reduce_wide":
            args, want = (torch.cat([xa, xb], 1),), plain(torch.cat([ca, cb], 1))
        elif op in pc._BINARY_FR_OPS:
            args, want = (xa, xb), plain(ca, cb)
        else:
            args, want = (xa,), plain(ca, c) if c else plain(ca)
        op_err = max(op_err, max_abs_err(pc.fr_op_cuda(op, *args, c=c), want))
    check(op_err == 0, f"fr op kernel disagrees with plain (max err {op_err})")
    print(f"phase 2 fr ops: {a.shape[0]} operands x {len(pc.FR_OPS)} ops, "
          f"non-canonical rows by value, "
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
    # multiple of the block; at G = 3 a partial warp of 9 or 11 and a
    # block of 40 states, +-1): one plain sponge per width over all of
    # them.
    edge_sizes = sorted({1, 9, 10, 11, 31, 33, 39, 40, 41, 517}
                        | {g + d for g in pc.LANES for d in (-1, 1) if g + d > 0})
    for w in WIDTHS:
        g_all = digits((sum(edge_sizes), w))
        g_all[::7, w - 1, 0] += 1 << 16
        want = poseidon.hash_multiple(g_all)
        limbs = fr.digits_to_limbs(g_all).contiguous()
        for g in pc.LANES:
            o = 0
            for size in edge_sizes:
                for got in (pc.sponge_limbs(limbs[o:o + size],
                                            poseidon.DS_MULTIPLE, lanes=g),
                            pc.sponge_digits(g_all[o:o + size],
                                             poseidon.DS_MULTIPLE, lanes=g)):
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
          f"every G {list(pc.LANES)} at batches {edge_sizes} = plain, on "
          f"limbs and on digits; "
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
    # K1's digit form on the same pairs, read by value in the kernel.
    k1_digits_ms = cuda_time_ms(
        lambda: pc.sponge_digits(pair_digits, poseidon.DS_PAIR))
    k1_err = max(k1_err, max_abs_err(
        fr.limbs_to_digits(pc.sponge_digits(pair_digits, poseidon.DS_PAIR)),
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
    k3_lanes = pc.choose_lanes(n_proofs, sms)
    # Every G at this shape, and at edge batches over arities 2, 3, 4 and 8
    # with tampered leaves, siblings and positions out of range.
    for g in pc.LANES:
        k3_err = max(k3_err, max_abs_err(pc.verify_digits(
            pos, tampered_sib, tampered_leaves, root, arity, lanes=g), plain_ok))
    # K3 alone at the automatic G, on the same proofs.
    k3_alone_ms = cuda_time_ms(lambda: pc.verify_digits(
        pos, tampered_sib, tampered_leaves, root, arity, lanes=k3_lanes))
    k3_edges = sorted({1, 9, 10, 11, 31, 33, 39, 40, 41, 517}
                      | {g + d for g in pc.LANES for d in (-1, 1) if g + d > 0})
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
        # One root a proof ([k, 16]): every fifth row altered.
        roots_e = small_tree[-1][0].expand(len(idx_e), 16).clone()
        roots_e[2::5, 0] ^= 1
        want_r = merkle._verify_plain(pe, se, le, roots_e, a_)
        for g in pc.LANES:
            for size in k3_edges:
                got = pc.verify_digits(pe[:size], se[:size], le[:size],
                                       small_tree[-1][0], a_, lanes=g)
                k3_err = max(k3_err, max_abs_err(got, want[:size]))
                got = pc.verify_digits(pe[:size], se[:size], le[:size],
                                       roots_e[:size], a_, lanes=g)
                k3_err = max(k3_err, max_abs_err(got, want_r[:size]))
        check(bool(want.any()) and not bool(want.all()), "K3 edge batch mixes")
        check(bool((want & ~want_r).any()), "K3 per-proof roots reject")
    check(k3_err == 0, "K3 disagrees with the plain verify")
    print(f"phase 6 verify: 5,000 proofs all true, tampered 10/20/30 false, "
          f"K3 = plain at every G {list(pc.LANES)} (auto G = {k3_lanes}) and "
          f"at batches {k3_edges} over arities 2, 3, 4, 8, with one root and "
          f"with a root a proof; warm verify "
          f"{verify_ms:.3f} ms; K3 alone at G = {k3_lanes} {k3_alone_ms:.4f} "
          f"ms on {name_power}", flush=True)
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

    # (7) K4 (permutation_cuda) against the plain permutation: 65,536 states
    # of full 256-bit values (most >= p), then rows holding every combination
    # of 0, 1, p - 1, p and 2^256 - 1 in the three lanes, a digit d + 2^16,
    # a digit 0xFFFFFFFF and a digit 2^40 - 1, each read by value.
    phase7_s = time.perf_counter()
    n_perm = 65536
    edges_int = [0, 1, constants.P - 1, constants.P, (1 << 256) - 1]
    combos = list(itertools.product(edges_int, repeat=3))
    odd = digits((3, 3))
    odd[0, 1, 5] += 1 << 16
    odd[1, 0, 0] = 0xFFFFFFFF
    odd[2, 2, 15] = (1 << 40) - 1
    states = torch.cat([
        digits((n_perm, 3)),
        row([v for c in combos for v in c]).reshape(len(combos), 3, fr.NDIGITS),
        odd,
    ])
    plain_perm = poseidon.permutation(states)
    k4_err = max_abs_err(pc.permutation_cuda(states), plain_perm)
    check(k4_err == 0, f"K4 disagrees with the plain permutation (max err {k4_err})")
    perm_digits = states[:n_perm].contiguous()
    k4_ms = cuda_time_ms(lambda: pc.permutation_cuda(perm_digits))
    k4_plain_ms = cuda_time_ms(lambda: poseidon.permutation(states[:n_perm]),
                               iters=1, warmup=0)
    # The sweep: each shape held against the plain permutation on 512 rows
    # spread over the batch.
    k4_sweep = {}
    for n_sw in K4_SWEEP:
        sw = digits((n_sw, 3))
        rows = torch.as_tensor(np.linspace(0, n_sw - 1, 512).astype(np.int64),
                               device=dev)
        k4_err = max(k4_err, max_abs_err(pc.permutation_cuda(sw)[rows],
                                         poseidon.permutation(sw[rows])))
        iters = max(3, 65536 * 10 // n_sw) if n_sw <= 65536 else 3
        k4_sweep[str(n_sw)] = {
            "ms": cuda_time_ms(lambda x=sw: pc.permutation_cuda(x), iters=iters),
            "bound_ms": bound(n_sw, n_sw * 6 * 128)[0],
        }
        del sw
    check(k4_err == 0, f"K4 disagrees with plain in the sweep (max err {k4_err})")
    # K4's SASS: the instructions a permutation issues, by opcode class,
    # and the issue bound they set at 65,536 states (one instruction a
    # clock on each of an SM's four schedulers).
    sass = sass_instructions(kernels.path, "permutation_digits_kernel")
    k4_sass = None
    if sass is not None:
        counts, static = k4_dynamic_counts(*sass)
        total = sum(counts.values())
        k4_sass = {"per_permutation": counts, "total": total, "static": static,
                   "issue_bound_ms": total * (n_perm / 32) / (sms * 4 * clock_hz) * 1e3}
    print(f"phase 7 permutation: {states.shape[0]} states (edge rows and "
          f"non-canonical digits included) K4 = plain; K4 {k4_ms:.3f} ms "
          f"through permutation_cuda, plain {k4_plain_ms:.3f} ms at {n_perm} "
          f"states; "
          f"sweep {k4_sweep} = plain on 512 rows a shape; SASS {k4_sass}; "
          f"phase {time.perf_counter() - phase7_s:.1f} s on {name_power}",
          flush=True)

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

    def sweep_point(label, fn, batch):
        times = {g: cuda_time_ms(lambda g=g: fn(g), iters=3, warmup=1)
                 for g in pc.LANES}
        auto = pc.choose_lanes(batch, sms)
        sweep[label] = {"ms": {str(g): t for g, t in times.items()},
                        "auto_lanes": auto,
                        "best_lanes": min(times, key=times.get)}
        print(f"phase 14 sweep {label}: " + ", ".join(
            f"G={g} {t:.3f} ms" for g, t in times.items())
            + f"; auto G={auto} on {name_power}", flush=True)

    for n_groups in (64, 1024, 4096, 5280, 5632, 6144, 8192, 10560, 10561,
                     12288, 16384, 65536):
        x4 = fr.digits_to_limbs(digits((n_groups, 4))).contiguous()
        sweep_point(f"K1 arity-4 x {n_groups}", lambda g, x=x4: pc.sponge_limbs(
            x, poseidon.DS_MULTIPLE, lanes=g), n_groups)
    for n_pairs in (64, 4096, 5280, 6144, 8192, 10560, 10561, 12288, 16384,
                    65536, 262144):
        x2 = fr.digits_to_limbs(digits((n_pairs, 2))).contiguous()
        sweep_point(f"K1 pairs x {n_pairs}", lambda g, x=x2: pc.sponge_limbs(
            x, poseidon.DS_PAIR, lanes=g), n_pairs)
    for n_k in (500, 2500, 4000, 5000, 5280, 5600, 7920, 10560, 10561, 13200,
                15840, 50000):
        idx14 = torch.as_tensor(
            np.random.default_rng(14).integers(0, n_leaves, n_k), device=dev)
        p14, s14 = tree.generate_batch_proofs(idx14)
        a14 = (p14, s14, tree.levels[0][idx14], root)
        sweep_point(f"K3 {n_k} x 8 levels", lambda g, a=a14: pc.verify_digits(
            *a, arity, lanes=g), n_k)
    resident = {f"{k} G={g}": pc.resident_states(dev, k, g)
                for k in ("sponge", "verify") for g in pc.LANES}
    warp_a_scheduler = sms * pc.SCHEDULERS_PER_SM * pc.SPLIT_GROUPS
    print(f"phase 14 resident states: {resident}; the split's states at one "
          f"warp a scheduler {warp_a_scheduler}, at "
          f"{pc.SPLIT_WARPS_PER_SCHEDULER} (where choose_lanes stops "
          f"splitting) {warp_a_scheduler * pc.SPLIT_WARPS_PER_SCHEDULER}",
          flush=True)

    # (15) Slice 5: the 1,048,576-leaf arity-8 tree on the card, then built
    # sharded by 1 rank and by 4 ranks that share the card.
    slice5, slice5_numbers, k1_err_1m, k3_err_1m = sharded_phase(
        dev, name_power, bound)
    k1_err, k3_err = max(k1_err, k1_err_1m), max(k3_err, k3_err_1m)

    # (16) Slice 6: the suites, the batch field ops, the int helpers and
    # the native oracle, on phase 2's operands.
    slice6, slice6_numbers = slice6_phase(dev, name_power, a, b, sms, clock_hz)

    k1_bound, k1_by = bound(65536, 65536 * 3 * 32)
    k3_perms = n_proofs * h * ((arity + 1) // 2)
    k3_bound, k3_by = bound(k3_perms, pos.numel() * 4 + sib.numel() * 8
                            + proved.numel() * 8 + 128 + n_proofs)
    k4_bound, k4_by = bound(n_perm, n_perm * 6 * 128)
    k1_lanes = pc.choose_lanes(65536, sms)
    by_slice = {"1": launches, "2": slice2, "3": slice3, "5": slice5,
                "6": slice6}
    record = {"kernels": [
        {"name": "sponge", "route": "cuda",
         "source": "cuzk_tpu_torch/csrc/poseidon_kernels.cu",
         "replaces": "cuzk_tpu/ops/poseidon_pallas.py:488",
         "launches": sum(s["sponge"] for s in by_slice.values()),
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "share": k1_bound / k1_ms, "lanes": k1_lanes,
         "library_ms": None, "digits_ms": k1_digits_ms},
        {"name": "verify", "route": "cuda",
         "source": "cuzk_tpu_torch/csrc/poseidon_kernels.cu",
         "replaces": "cuzk_tpu/ops/poseidon_pallas.py:385",
         "launches": sum(s["verify"] for s in by_slice.values()),
         "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "share": k3_bound / k3_ms, "lanes": k3_lanes,
         "library_ms": None},
        {"name": "permutation", "route": "cuda",
         "source": "cuzk_tpu_torch/csrc/poseidon_kernels.cu",
         "replaces": "cuzk_tpu/ops/poseidon_pallas.py:795",
         "launches": sum(s["permutation"] for s in by_slice.values()),
         "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
         "bound_by": k4_by, "share": k4_bound / k4_ms, "lanes": 1,
         "library_ms": None, "sweep": k4_sweep, "sass": k4_sass},
        {"name": "fr_op", "route": "cuda",
         "source": "cuzk_tpu_torch/csrc/poseidon_kernels.cu",
         "replaces": "cuzk_tpu/field/batch.py:42",
         "launches": sum(s["fr_op"] for s in by_slice.values()),
         "max_abs_err": max(op_err, slice6_numbers["fr_sub_err"]),
         "ms": slice6_numbers["fr_sub_ms"],
         "plain_ms": slice6_numbers["fr_sub_plain_ms"],
         "bound_ms": slice6_numbers["fr_sub_bound_ms"],
         "bound_by": "bytes",
         "share": slice6_numbers["fr_sub_bound_ms"] / slice6_numbers["fr_sub_ms"],
         "lanes": 1, "library_ms": None, "op": "sub"},
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
        "build_50k_k1_ms": build_k1_ms, "launches_by_slice": by_slice,
        **slice5_numbers, **slice6_numbers, "sweep": sweep,
        "resident_states": resident, "clocks_max_sm_mhz": clock_hz / 1e6,
        "ptxas": kernels.ptxas, "kernel_sass": kernel_sass, "card": name_power}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sharded_rank(sys.argv[2:])
        sys.exit(0)
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
