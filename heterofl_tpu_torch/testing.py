"""Closeness checks that also report the measured difference.

The port's parity tests and ``chip_smoke.py`` hold one result against
another (the port against the JAX reference on the CPU, a CUDA kernel
against its plain PyTorch version on the card) and print what they
measured, one ``parity`` line per check, so the differences recorded in
``PERF.md`` come from the same code that asserts them::

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_*.py -s -p no:xdist | grep -o 'parity .*'
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):  # a torch tensor, on any device
        a = a.detach().to("cpu").numpy()
    return np.asarray(a, dtype=np.float64)


def assert_close(what: str, actual, desired, *, rtol: float, atol: float
                 ) -> Tuple[float, float]:
    """Assert ``|actual - desired| <= atol + rtol * |desired|`` elementwise
    (``rtol = atol = 0`` asks for equal values), print the largest absolute
    and relative differences, and return them.  The relative difference is
    taken over the entries with ``|desired| > atol`` (near zero only the
    absolute one means anything).  NaNs must sit at the same places; they
    count as equal."""
    a, d = _host(actual), _host(desired)
    if a.shape != d.shape:
        raise AssertionError(f"{what}: shape {a.shape} != {d.shape}")
    both = np.isfinite(a) & np.isfinite(d)
    diff = np.abs(a - d)[both]
    max_abs = float(diff.max()) if diff.size else 0.0
    big = np.abs(d[both]) > max(atol, np.finfo(np.float32).tiny)
    rel = diff[big] / np.abs(d[both][big])
    max_rel = float(rel.max()) if rel.size else 0.0
    print(f"parity {what}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
          f"(rtol {rtol:g}, atol {atol:g})", flush=True)
    np.testing.assert_allclose(a, d, rtol=rtol, atol=atol, err_msg=what)
    return max_abs, max_rel
