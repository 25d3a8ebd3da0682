"""The benchmark's frozen reference against the golden vectors of SURVEY.md
Appendix A (produced by the cuZK reference's compiled CPU code), and the
control's constant against them."""

import pytest
import torch

from zkbench.reference import constants, field, merkle, poseidon

HASH_PAIR_10_20 = 0x2DD359F92D31C747E06C02B360A9F5C761777B285EDCF09724EFEF5CBD51D9BA


@pytest.fixture(scope="module")
def h():
    return poseidon.Poseidon(field.Field("cpu"))


def digits(xs):
    return torch.tensor([field.int_to_digits(x) for x in xs])


def as_int(t):
    return field.digits_to_int(t.tolist())


def test_round_constants():
    assert constants.RC[0] == 0x123456789ABCDEF
    assert constants.RC[191] == 0xDA7414C3456788DF


def test_permutation(h):
    out = h.permute(digits([1, 2, 3])[None])[0]
    assert [as_int(x) for x in out] == [
        0x07B845866686A60A43F75F0CD778887CC9C304376FCD0B3DE6964E45B9630501,
        0x0EF091199ADBCCB5A4F16D125495A5088EFAD30E7157B84E7429C087D234C932,
        0x157A12C9C56AE74429660DFB6AEBDF9148E6AFB977080BE9C424CCB07472AE04,
    ]


@pytest.mark.parametrize("inputs,ds,want", [
    ([42], 1, 0x066E59AED12901E110F7D8459D3C2FA7705B3CE5A5EB1C7593E7E1465F85DAFB),
    ([10, 20], 2, HASH_PAIR_10_20),
    ([42, 0], 2, 0x0F6E1ADBCD1DE3D6161CD9CFC7DAD8C98D9ACEDC903B3E94C2CC8DF4C3001580),
    ([1, 2, 3, 4], 3, 0x2C12B96D3926E4862876AE9CA67CDDAD85313FA6FA5F266FB7AB683826A6A497),
])
def test_sponge(h, inputs, ds, want):
    assert as_int(h.sponge(digits(inputs)[None], ds)[0]) == want


def test_empty_input_hashes_to_zero(h):
    empty = torch.zeros((1, 0, field.NDIGITS), dtype=torch.int64)
    assert as_int(h.sponge(empty, 3)[0]) == 0


@pytest.mark.parametrize("arity,want", [
    (2, 0x194324F01EFA21D2DCDD7453800FDE166A852E2906E0E6DE5DE6921EEB77FEEC),
    (4, 0x1C7842D7703C243A99D6E6CA4033851791B5AE206220FC8C9BCDDE10E5BEFBDD),
    (8, 0x2CA165C9C68473C20EB293F63DE5986E10A90FB68F6E54BD7932E5166048445D),
])
def test_empty_hash(h, arity, want):
    assert as_int(merkle.empty_hash(h, arity)) == want


@pytest.mark.parametrize("leaves,arity,want", [
    ([1, 2], 2, 0x28C245BFD4D7A4D1EE6BA330337ADC309F013D29C9326C28BA0D3CB47027FCA6),
    ([1, 2, 3, 4], 2, 0x236B917229EEEA3EE41C637A7C3CC01F727AC1DC5108C962F564ACC1D8730E44),
    ([1, 2, 3, 4, 5], 3, 0x28B819C1EB91377E70ED6E8BBB4C526B9B7ABABAFDCB021E135791FC4F3E25AA),
])
def test_merkle_root(h, leaves, arity, want):
    levels = merkle.build_levels(h, digits(leaves)[None], arity)
    assert as_int(levels[-1][0, 0]) == want


def test_proof_of_leaf_2_verifies_and_a_tampered_one_does_not(h):
    levels = [lv[0] for lv in merkle.build_levels(h, digits([1, 2, 3, 4])[None], 2)]
    pos, sib = merkle.gather_proofs(levels, 2, torch.tensor([2, 2]))
    assert pos.shape == (2, 2)
    sib[1, 1, 0, 3] ^= 1
    ok = merkle.verify(h, pos, sib, levels[0][[2, 2]], levels[-1][0], 2)
    assert ok.tolist() == [True, False]


def test_truncated_multiply():
    f = field.Field("cpu")
    a = 0x123456789ABCDEF0FEDCBA987654321011112222333344445555666677778888
    b = 0x0FEDCBA987654321123456789ABCDEF0AAAABBBBCCCCDDDDEEEEFFFF00001111
    assert as_int(f.mul(digits([a]), digits([b]))[0]) == \
        0x19F690DF510F402FFEF3BF6BFC5F36BF54CAC399B184B355725667A3EEFC6378


def test_control_constant_breaks_the_semantics():
    """The control computes with the cuZK CUDA sources' k (+4): the
    golden pair hash no longer comes out."""
    ctl = poseidon.Poseidon(field.Field("cpu", constants.K_CUDA))
    assert constants.K_CUDA == constants.K + 4
    assert as_int(ctl.sponge(digits([10, 20])[None], 2)[0]) != HASH_PAIR_10_20
