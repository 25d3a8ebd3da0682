"""The benchmark's plain reference: BN254-Fr, Poseidon and n-ary Merkle
trees in plain PyTorch, with the cuZK reference's CPU semantics (the
truncated k-fold reduction, SURVEY.md Appendix A).

A frozen copy of the plain versions the port carries beside its kernels,
kept here so that a change to the port cannot move the yardstick.  It
imports no package of this repository.  ``k`` is a parameter so that the
benchmark's control can compute with the cuZK CUDA sources' constant
(off by 4) in place of 2^256 mod p.
"""
