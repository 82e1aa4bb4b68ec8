"""Closeness checks that also report the measured difference.

The port's parity tests and ``chip_smoke.py`` hold one result against
another (the port against the JAX reference on the CPU, a CUDA kernel
against its plain PyTorch version on the card) and print what they
measured, one ``parity`` line per check, so the differences recorded in
``PERF.md`` come from the same code that asserts them::

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_*.py -s -p no:xdist | grep -o 'parity .*'
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import numpy as np
import torch

#: torch's intra-op threads a port test runs on
TEST_THREADS = 2


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


def assert_grid_close(what: str, actual, desired, step, *, atol: float, max_share: float
                      ) -> Tuple[float, float]:
    """The contract of a quantised result whose inputs differ by float
    rounding: every entry within ``atol``, except at most a share
    ``max_share`` of entries that landed one grid step apart, each within
    ``step + atol`` (``step`` per entry, the grid's step).  Prints the
    largest absolute difference and the share off by a step, and returns
    them."""
    a, d, st = _host(actual), _host(desired), np.broadcast_to(_host(step), _host(desired).shape)
    if a.shape != d.shape:
        raise AssertionError(f"{what}: shape {a.shape} != {d.shape}")
    diff = np.abs(a - d)
    off = ~(diff <= atol)
    share = float(off.mean()) if off.size else 0.0
    max_abs = float(diff.max()) if diff.size else 0.0
    steps = float((diff[off] / np.maximum(st[off], 1e-30)).max()) if off.any() else 0.0
    print(f"parity {what}: max_abs_err {max_abs:.3e} share_off_by_a_step {share:.3e} "
          f"({int(off.sum())} of {off.size}, at most {steps:.3f} steps) "
          f"(atol {atol:g}, max_share {max_share:g})", flush=True)
    if share > max_share:
        raise AssertionError(f"{what}: {share:.3e} of the entries differ by more than "
                             f"{atol:g} (allowed {max_share:g})")
    if not np.all(diff[off] <= st[off] + atol):
        raise AssertionError(f"{what}: an entry differs by more than one grid step")
    return max_abs, share


@contextlib.contextmanager
def limited_threads(deterministic: bool = False) -> Iterator[None]:
    """Run the body on at most :data:`TEST_THREADS` torch threads (and, with
    ``deterministic``, under ``torch.use_deterministic_algorithms``), and
    put both settings back after.  The port's CPU tests run many small
    ops, each a short parallel region; several test processes side by side,
    each at torch's default of a thread a core, leave those regions waiting
    on descheduled threads (a file that takes 12.8 s alone took 374 s
    beside one other process)."""
    before_threads = torch.get_num_threads()
    before_det = torch.are_deterministic_algorithms_enabled()
    torch.set_num_threads(min(before_threads, TEST_THREADS))
    if deterministic:
        torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before_det)
        torch.set_num_threads(before_threads)


def thread_limit_fixture(deterministic: bool = False):
    """An autouse, module-scoped pytest fixture that runs the module that
    binds it under :func:`limited_threads`::

        few_threads = thread_limit_fixture()

    Module-scoped, so the module's own module-scoped fixtures (a reference
    run computed once for several tests) run under it too: pytest sets up
    a scope's autouse fixtures before its other fixtures, while a
    function-scoped limit would start only after them."""
    import pytest  # the tests' dependency, not the package's

    @pytest.fixture(scope="module", autouse=True)
    def _limited_threads():
        with limited_threads(deterministic):
            yield

    return _limited_threads
