"""Marks the cases that test_benchmark_control.py draws for a cell it has
no data for.  That file sizes each cell by name (SIZE) and breaks the
timed path by entry name; beam4m5.ic0_f64 came after it, so its four cases
there stop at the KeyError of SIZE.  test_benchmark_beam.py holds that
cell's control and its three faults meanwhile.  The mark is strict and
takes only a KeyError: once that file knows the cell, the cases pass, the
mark fails them, and it has to go."""

import pytest

NOT_IN_CONTROL = ("beam4m5.ic0_f64",)


def pytest_collection_modifyitems(items):
    for item in items:
        spec = getattr(item, "callspec", None)
        if item.path.name == "test_benchmark_control.py" and spec and \
                spec.params.get("name") in NOT_IN_CONTROL:
            item.add_marker(pytest.mark.xfail(
                raises=KeyError, strict=True,
                reason="SIZE and _fault_run know no such cell: "
                       "test_benchmark_beam.py carries its control and "
                       "faults"))
