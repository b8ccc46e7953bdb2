"""The plain reference, the records rule, the comparison and its control,
on small inputs."""

import numpy as np
import pytest

from sortbench import reference

TERA = {"key_bytes": 10}


def _records(n, seed, key_space=None):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_space or 2**63, size=n, dtype=np.uint64)
    payload = rng.integers(0, 256, size=(n, 92), dtype=np.uint8)
    return keys, payload


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint32, np.uint64])
def test_keys_reference_is_np_sort(dtype):
    info = np.iinfo(dtype)
    rng = np.random.default_rng(1)
    x = rng.integers(info.min, info.max, size=5000, dtype=dtype, endpoint=True)
    x[:4] = [info.min, info.max, info.min, info.max]
    ref = reference.reference("keys", x, {})
    assert np.array_equal(ref, np.sort(x)) and ref.dtype == x.dtype
    assert reference.mismatched("keys", np.sort(x), ref, {}) == 0


def test_keys_mismatches_are_counted():
    ref = np.arange(100, dtype=np.int32)
    swapped = ref.copy()
    swapped[[3, 7]] = swapped[[7, 3]]
    assert reference.mismatched("keys", swapped, ref, {}) == 2
    assert reference.mismatched("keys", ref[:60], ref, {}) == 40
    assert reference.mismatched("keys", ref.astype(np.int64), ref, {}) == 100
    assert reference.mismatched("keys", np.concatenate([ref, ref[:5]]), ref, {}) == 5


def test_records_follow_the_whole_ten_byte_key():
    keys, payload = _records(3000, 2, key_space=4)  # many equal 8-byte prefixes
    ref_k, ref_p = reference.reference("records", (keys, payload), TERA)
    whole = [(int(k), int(p[0]), int(p[1])) for k, p in zip(keys, payload)]
    assert [(int(k), int(p[0]), int(p[1])) for k, p in zip(ref_k, ref_p)] == sorted(whole)
    assert sorted(map(bytes, ref_p)) == sorted(map(bytes, payload))
    assert reference.mismatched("records", (ref_k, ref_p), (ref_k, ref_p), TERA) == 0


def test_records_with_equal_keys_compare_as_a_multiset():
    keys, payload = _records(2000, 3, key_space=3)
    payload[:, :2] = 0  # whole keys tie in three large groups
    ref = reference.reference("records", (keys, payload), TERA)
    rng = np.random.default_rng(4)
    out_k, out_p = ref[0].copy(), ref[1].copy()
    for v in range(3):  # shuffle every tie group
        idx = np.flatnonzero(out_k == v)
        out_p[idx] = out_p[rng.permutation(idx)]
    assert reference.mismatched("records", (out_k, out_p), ref, TERA) == 0
    out_p[5, 50] ^= 1
    assert reference.mismatched("records", (out_k, out_p), ref, TERA) == 1
    moved = (np.roll(out_k, 1), np.roll(out_p, 1, axis=0))
    assert reference.mismatched("records", moved, ref, TERA) > 0


def test_records_mismatches_are_counted():
    keys, payload = _records(1000, 5)
    ref = reference.reference("records", (keys, payload), TERA)
    out_p = ref[1].copy()
    out_p[10, 3] ^= 7
    out_k = ref[0].copy()
    out_k[20] += np.uint64(1)
    assert reference.mismatched("records", (out_k, out_p), ref, TERA) == 2
    assert reference.mismatched("records", (ref[0][:900], ref[1][:900]), ref, TERA) == 100
    assert reference.mismatched("records", (ref[0], ref[1][:, :91]), ref, TERA) == 1000


@pytest.mark.parametrize("kind", ["keys", "records"])
def test_control_one_precision_lower_is_not_correct(kind):
    rng = np.random.default_rng(6)
    if kind == "keys":
        job = rng.integers(-2**31, 2**31 - 1, size=1 << 16, dtype=np.int32)
    else:
        job = _records(1 << 16, 6)
    ref = reference.reference(kind, job, TERA)
    assert reference.mismatched(kind, reference.control(kind, job, TERA), ref, TERA) > 0


def test_control_agrees_where_float32_holds_every_key():
    small = np.arange(1000, dtype=np.int32)[::-1].copy()
    assert reference.mismatched("keys", reference.control("keys", small, {}),
                                reference.reference("keys", small, {}), {}) == 0
