"""Structured (record) dtype host lane.

VERDICT round-2 missing item 2: the reference inherits record arrays free
through numpy chunk kernels (field access in
``tests/test_collection.py::test_field_access`` /
``test_field_access_with_shape``); jax has no record dtypes, so here they
live on the HOST lane (eager executor, numpy blocks) and field access
returns ordinary numeric arrays.
"""

import os

import numpy as np
import pytest

import dask_array_tpu as da
from dask_array_tpu._test_utils import assert_eq

DT = [("a", "i4"), ("b", "f4")]


@pytest.fixture
def rec():
    x = np.empty(12, dtype=[("a", "f8"), ("b", "i4"), ("c", "f4")])
    x["a"] = np.linspace(0, 1, 12)
    x["b"] = np.arange(12)
    x["c"] = 2.0
    return x


def test_field_access_reference_case():
    # reference tests/test_collection.py:576
    x = np.array([(1, 1.0), (2, 2.0)], dtype=DT)
    y = da.from_array(x, chunks=(1,))
    assert_eq(y["a"], x["a"])
    assert_eq(y[["b", "a"]], x[["b", "a"]])


def test_field_access_with_shape_reference_case():
    # reference tests/test_collection.py:583 — sub-array fields add axes
    dtype = [("col1", ("f4", (3, 2))), ("col2", ("f4", 3))]
    data = np.ones((20, 10), dtype=dtype)
    x = da.from_array(data, 5)
    assert_eq(x["col1"], data["col1"])
    assert_eq(x[["col1"]], data[["col1"]])
    assert_eq(x["col2"], data["col2"])
    assert_eq(x[["col1", "col2"]], data[["col1", "col2"]])


def test_field_then_device_arithmetic(rec):
    x = da.from_array(rec, chunks=4)
    got = (x["a"] * 2 + x["b"]).compute()
    np.testing.assert_allclose(got, rec["a"] * 2 + rec["b"])


def test_field_reduction_2d():
    rec2 = np.zeros((6, 4), dtype=[("u", "f8"), ("v", "f8")])
    rec2["u"] = np.arange(24).reshape(6, 4)
    y = da.from_array(rec2, chunks=(3, 2))
    np.testing.assert_allclose(y["u"].sum(axis=0).compute(), rec2["u"].sum(axis=0))


def test_structured_slicing_and_identity(rec):
    x = da.from_array(rec, chunks=4)
    np.testing.assert_array_equal(x[3:9].compute(), rec[3:9])
    np.testing.assert_array_equal(x.compute(), rec)
    np.testing.assert_array_equal(x[::-1].compute(), rec[::-1])


def test_structured_concat_stack_rechunk(rec):
    x = da.from_array(rec, chunks=4)
    np.testing.assert_array_equal(
        da.concatenate([x, x]).compute(), np.concatenate([rec, rec])
    )
    np.testing.assert_array_equal(da.stack([x, x]).compute(), np.stack([rec, rec]))
    np.testing.assert_array_equal(x.rechunk(3).compute(), rec)


def test_structured_npy_stack_roundtrip(rec, tmp_path):
    x = da.from_array(rec, chunks=4)
    p = os.path.join(str(tmp_path), "stk")
    da.to_npy_stack(p, x)
    back = da.from_npy_stack(p)
    np.testing.assert_array_equal(back.compute(), rec)


def test_missing_field_raises(rec):
    x = da.from_array(rec, chunks=4)
    with pytest.raises(KeyError):
        x["zz"]
    with pytest.raises(KeyError):
        x[["a", "zz"]]


def test_field_access_on_numeric_raises():
    with pytest.raises(IndexError):
        da.ones((4,), chunks=2)["a"]


def test_structured_arithmetic_raises(rec):
    x = da.from_array(rec, chunks=4)
    with pytest.raises(Exception):  # numpy/jax reject arithmetic on records
        (x + 1).compute()
