"""The port's int64-bit-pattern helpers (sourmash_tpu_torch/ops/u64.py)
against numpy uint64 arithmetic, on seeded values that include 0, 2^63 and
2^64-1. Every comparison is exact."""

import numpy as np
import pytest
import torch

from sourmash_tpu_torch.ops import u64

EDGES = np.array(
    [0, 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1],
    dtype=np.uint64,
)


@pytest.fixture(scope="module")
def values():
    rng = np.random.default_rng(64)
    rand = rng.integers(0, 2**64, size=2000, dtype=np.uint64, endpoint=False)
    return np.concatenate([EDGES, rand, rand[:50] | np.uint64(1 << 63)])


def test_roundtrip_is_bitwise(values):
    t = u64.from_numpy(values)
    assert t.dtype == torch.int64
    assert np.array_equal(u64.to_numpy(t), values)
    assert u64.signed(2**64 - 1) == -1 and u64.signed(2**63) == -(2**63)


@pytest.mark.parametrize("c", [0, 1, 5, 0x87C37B91114253D5, 0xFF51AFD7ED558CCD, 2**63, 2**64 - 1])
def test_multiply_wraps_like_uint64(values, c):
    with np.errstate(over="ignore"):
        want = values * np.uint64(c)
    assert np.array_equal(u64.to_numpy(u64.mul(u64.from_numpy(values), c)), want)


def test_add_and_tensor_multiply_wrap(values):
    a, b = values, values[::-1].copy()
    with np.errstate(over="ignore"):
        want_add, want_mul = a + b, a * b
    ta, tb = u64.from_numpy(a), u64.from_numpy(b)
    assert np.array_equal(u64.to_numpy(ta + tb), want_add)
    assert np.array_equal(u64.to_numpy(ta * tb), want_mul)


@pytest.mark.parametrize("r", [1, 8, 27, 31, 32, 33, 56, 63])
def test_rotl_and_logical_shift(values, r):
    rr, lr = np.uint64(r), np.uint64(64 - r)
    t = u64.from_numpy(values)
    assert np.array_equal(u64.to_numpy(u64.srl(t, r)), values >> rr)
    assert np.array_equal(u64.to_numpy(t << r), values << rr)
    assert np.array_equal(u64.to_numpy(u64.rotl(t, r)), (values << rr) | (values >> lr))


def test_unsigned_compare(values):
    a, b = values, np.roll(values, 7)
    ta, tb = u64.from_numpy(a), u64.from_numpy(b)
    assert np.array_equal(u64.le(ta, tb).numpy(), a <= b)
    for limit in (0, 2**63 - 1, 2**63, (2**64 - 1) // 1000, 2**64 - 1):
        assert np.array_equal(u64.le(ta, limit).numpy(), a <= np.uint64(limit)), limit
    assert bool(u64.le(2**64 - 1, ta).any()) == bool((values == np.uint64(2**64 - 1)).any())


def test_unsigned_sort(values):
    t = u64.from_numpy(values)
    assert np.array_equal(u64.to_numpy(u64.sort(t)), np.sort(values))
    rows = u64.from_numpy(values[:2000].reshape(4, 500))
    assert np.array_equal(u64.to_numpy(u64.sort(rows, dim=1)), np.sort(values[:2000].reshape(4, 500), axis=1))


def test_u32_halves(values):
    t = u64.from_numpy(values)
    hi, lo = u64.hi32(t), u64.lo32(t)
    assert hi.dtype == lo.dtype == torch.int32
    assert np.array_equal(hi.numpy().view(np.uint32), (values >> np.uint64(32)).astype(np.uint32))
    assert np.array_equal(lo.numpy().view(np.uint32), (values & np.uint64(2**32 - 1)).astype(np.uint32))
    assert np.array_equal(u64.to_numpy(u64.join32(hi, lo)), values)
