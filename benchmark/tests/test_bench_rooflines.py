"""The roofline counts at small shapes, worked out by hand."""

import pytest
import torch

from benchlib.manifest import part

peaks = part("rooflines", "peaks")
k1mma = part("rooflines", "k1mma")
k3 = part("rooflines", "k3")
k4 = part("rooflines", "k4")
k6 = part("rooflines", "k6")

HBM, INT8 = 3.35e12, 1979e12


def test_k4_small_shape_is_bound_by_bytes():
    rec = {"topk_needles": 2, "n_valid": 3, "n_rows": 4, "k": 5}
    # 8*3 live hashes + 4 validity bytes + 2*8 needles + 2*5*8 outputs
    assert k4.least_s(rec) == pytest.approx(124 / HBM)


def test_k4_query_shape_is_bound_by_the_int8_rate():
    rec = {"topk_needles": 1024, "n_valid": 9_900_000,
           "n_rows": 10_000_000, "k": 64}
    assert k4.least_s(rec) == pytest.approx(128 * 1024 * 9_900_000 / INT8)
    assert k4.least_s({"topk_needles": 0}) is None


def test_k1mma_counts_every_needle_against_every_live_row():
    rec = {"gate_needles": 8192, "n_valid": 9_900_000, "n_rows": 10_000_000}
    assert k1mma.least_s(rec) == pytest.approx(128 * 8192 * 9_900_000 / INT8)
    # 1 needle, 10 rows: 8*10 + 10 + 12 bytes
    small = {"gate_needles": 1, "n_valid": 10, "n_rows": 10}
    assert k1mma.least_s(small) == pytest.approx(102 / HBM)


def test_k3_blocks_partition_the_64_bits_as_the_port_did():
    masks = [m % (1 << 64) for m in k3.block_masks(5)]
    assert [bin(m).count("1") for m in masks] == [13, 13, 13, 13, 12]
    total = 0
    for m in masks:
        assert total & m == 0
        total |= m
    assert total == (1 << 64) - 1
    assert [hex(m) for m in masks] == [
        "0x82f1000000d1840", "0x24c0023180504100", "0x5200000a07200609",
        "0x110290078822080", "0x8000c4c400008036"]


def test_k3_equal_key_pairs_by_hand():
    t = 5
    four_equal = torch.full((4,), 12345, dtype=torch.int64)
    valid = torch.ones(4, dtype=torch.bool)
    assert k3.equal_key_pairs(four_equal, valid, t) == 6 * t  # C(4,2) a block
    # two rows differing in one bit of block 0: equal in the other 4 blocks
    bit = (k3.block_masks(t)[0] % (1 << 64)).bit_length() - 1
    pair = torch.tensor([0, 1 << bit if bit < 63 else -(1 << 63)])
    assert k3.equal_key_pairs(pair, torch.ones(2, dtype=torch.bool), t) == 4
    # an invalid row pairs with nothing
    assert k3.equal_key_pairs(four_equal, torch.tensor(
        [True, True, True, False]), t) == 3 * t
    rec = {"k3_pairs": 10, "k3_blocks": 5, "n_rows": 100}
    assert k3.least_s(rec) == pytest.approx(17 * 100 * 5 / HBM)


def test_k6_work_by_hand():
    # needle of 2 colors against rows of 1, 2 and 5 colors: the pair (2, 1)
    # takes 7*2*1 + 3*2, (2, 2) 7*2*2 + 3*2, (2, 5) scores nothing
    ops, nbytes = k6.work([2], [1, 2, 5])
    assert ops == 20 + 34
    assert nbytes == 388 + 389 * 3 + 4 * 3
    rec = {"k6_instructions": 33.5e12, "k6_bytes": 0}
    assert k6.least_s(rec) == pytest.approx(1.0)  # a second at the peak


def test_peaks_are_the_published_h100_sxm_numbers():
    assert peaks.HBM_BYTES_PER_S == HBM
    assert peaks.INT8_TENSOR_OPS_PER_S == INT8
    assert peaks.FP32_INSTRUCTIONS_PER_S == 67e12 / 2
