"""pytest plugin for the port's dtsan runtime sanitizer (``sanitizer.py``).

The counterpart of the JAX package's ``analysis/pytest_sanitizer.py``,
as a standalone plugin::

    python -m pytest -p dynamo_tpu_torch.analysis.pytest_sanitizer tests/test_torch_*.py

Policy: task-LEAK checking by default — a passing test that leaves a
live task behind fails with the task's creation traceback.
``DYNAMO_SANITIZE=1`` upgrades to the full instrument set (blocking
callbacks over ``DYNAMO_SANITIZE_BLOCK_S``, 0.25 s unless set, unclosed
transports, frame-protocol violations through the port's framing);
``DYNAMO_SANITIZE=0`` disables everything.

This repository's ``tests/conftest.py`` installs the JAX package's
sanitizer for every test; loaded beside it, this plugin installs the
port's on top, and the two nest (``sanitizer.py``).

Grandfathered files mirror the lint-baseline idiom: module-level entries
whose tests intentionally keep background services alive across tests,
each with its reason.  None of the port's test files needs one: every
port test, the mesh worlds' included, passes the default leak check
under this plugin as under the JAX suite's, which reads the same seams.
The plugin leaves its patches in place until the process exits, as the
JAX suite's does.
"""

from __future__ import annotations

import os
from typing import Optional

import pytest

from dynamo_tpu_torch.analysis.sanitizer import MODE_OFF, Sanitizer, mode_from_env

__all__ = [
    "configure",
    "begin_test",
    "check_report",
    "get_sanitizer",
    "LEAK_GRANDFATHERED_FILES",
]

# Files exempt from per-test sanitizer failures, each with the reason it
# is grandfathered; remove an entry when the file is fixed, and grow the
# set only with a justification.
LEAK_GRANDFATHERED_FILES: dict[str, str] = {}

# threshold for the blocking-callback monitor (full mode)
_BLOCKING_THRESHOLD_S = float(os.environ.get("DYNAMO_SANITIZE_BLOCK_S", "0.25"))

_sanitizer: Optional[Sanitizer] = None


def get_sanitizer() -> Optional[Sanitizer]:
    return _sanitizer


def configure(config=None) -> Optional[Sanitizer]:
    """Install the sanitizer per DYNAMO_SANITIZE (idempotent)."""
    global _sanitizer
    if _sanitizer is not None:
        return _sanitizer
    mode = mode_from_env()
    if mode == MODE_OFF:
        return None
    _sanitizer = Sanitizer(mode, blocking_threshold_s=_BLOCKING_THRESHOLD_S).install()
    return _sanitizer


def begin_test(item=None) -> None:
    """Open a fresh epoch: findings are attributed to the test between
    this call and its check_report."""
    if _sanitizer is not None:
        _sanitizer.begin_epoch()


def check_report(item, call, rep) -> None:
    """Flip a PASSING call-phase report to failed on sanitizer findings.

    Failing tests are left alone (the real failure is the signal there),
    and grandfathered files and ``no_sanitize`` tests are exempt.
    Mutates ``rep`` in place; call from a hookwrapper
    ``pytest_runtest_makereport``.
    """
    if _sanitizer is None or rep.when != "call" or not rep.passed:
        return
    if os.path.basename(str(item.fspath)) in LEAK_GRANDFATHERED_FILES:
        return
    if item.get_closest_marker("no_sanitize") is not None:
        return
    findings = _sanitizer.epoch_report()
    if not findings:
        return
    rep.outcome = "failed"
    rep.longrepr = (
        f"{item.nodeid}: dtsan found {len(findings)} issue"
        f"{'s' if len(findings) != 1 else ''} at teardown:\n\n"
        + "\n\n".join(findings)
        + "\n\nFix the leak (cancel AND reap the task / close_writer the "
        "stream), mark the test @pytest.mark.no_sanitize with a reason, "
        "or — for pre-existing debt only — grandfather the file, with its "
        "reason, in pytest_sanitizer.LEAK_GRANDFATHERED_FILES."
    )


# ------------------------------------------------------------ plugin hooks ----


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "no_sanitize: exempt this test from dtsan runtime-sanitizer "
        "failures (leaked tasks / blocking callbacks / unclosed "
        "transports)",
    )
    configure(config)


def pytest_runtest_setup(item):
    begin_test(item)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    outcome = yield
    check_report(item, call, outcome.get_result())
