"""The port's dtsan runtime sanitizer (``analysis/sanitizer.py`` and the
standalone ``analysis/pytest_sanitizer.py`` plugin).

Each instrument catches its injected bug (a leaked task, a blocking
callback, an unclosed transport, an illegal frame sequence through the
port's framing), as in the JAX suite's sanitizer tests.  The port's
sanitizer and the JAX package's can be installed in one process (this
suite runs under the JAX suite's default leak check): installs nest last
in, first out, each framing guard patches only its own package's modules,
and an uninstall out of order is refused.  Last, the plugin itself in a
subprocess over a temporary test directory.
"""

import asyncio
import asyncio.events as ev
import asyncio.selector_events as sel
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

import dynamo_tpu_torch
from dynamo_tpu.analysis import sanitizer as jax_san
from dynamo_tpu.runtime.transports import framing as jax_framing
from dynamo_tpu.runtime.transports import tcp as jax_tcp
from dynamo_tpu_torch.analysis import pytest_sanitizer as plugin
from dynamo_tpu_torch.analysis.sanitizer import (
    MODE_FULL,
    MODE_LEAKS,
    MODE_OFF,
    BlockingCallbackMonitor,
    FrameProtocolError,
    FrameStateMachine,
    FramingGuard,
    Sanitizer,
    TaskTracker,
    TransportTracker,
    mode_from_env,
)
from dynamo_tpu_torch.runtime.transports import framing
from dynamo_tpu_torch.runtime.transports import tcp

ROOT = Path(dynamo_tpu_torch.__file__).resolve().parents[1]


def _reap(loop, tasks):
    for t in tasks:
        t.cancel()
    if tasks:
        loop.run_until_complete(asyncio.gather(*tasks, return_exceptions=True))


async def _leaky_body():
    asyncio.ensure_future(asyncio.sleep(60))
    await asyncio.sleep(0)


# ------------------------------------------------------------ task leaks ----


def test_injected_task_leak_is_caught():
    tracker = TaskTracker()
    loop = asyncio.new_event_loop()
    try:
        tracker.instrument_loop(loop)
        tracker.begin_epoch()
        loop.run_until_complete(_leaky_body())
        pending = tracker.pending_in_epoch()
        assert len(pending) == 1 and tracker.tracked_in_epoch() == 2
        task, rec = pending[0]
        assert "test_torch_sanitizer.py" in rec.render() and "_leaky_body" in rec.render()
        _reap(loop, [task])
        assert tracker.pending_in_epoch() == []
    finally:
        _reap(loop, list(asyncio.all_tasks(loop)))
        loop.close()


def test_cancel_requested_task_is_not_a_leak():
    tracker = TaskTracker()
    loop = asyncio.new_event_loop()
    try:
        tracker.instrument_loop(loop)
        tracker.begin_epoch()

        async def stubborn():
            try:
                await asyncio.sleep(60)
            except asyncio.CancelledError:
                await asyncio.sleep(60)  # swallow the first cancel: stays pending

        async def go():
            t = asyncio.ensure_future(stubborn())
            await asyncio.sleep(0)
            t.cancel()

        loop.run_until_complete(go())
        assert tracker.pending_in_epoch() == []
        assert len(tracker.pending_in_epoch(include_cancel_requested=True)) == 1
    finally:
        _reap(loop, list(asyncio.all_tasks(loop)))
        loop.close()


def test_epoch_scoping_attributes_leaks_to_their_test():
    tracker = TaskTracker()
    loop = asyncio.new_event_loop()
    try:
        tracker.instrument_loop(loop)
        tracker.begin_epoch()
        loop.run_until_complete(_leaky_body())
        assert len(tracker.pending_in_epoch()) == 1
        tracker.begin_epoch()
        assert tracker.pending_in_epoch() == [] and tracker.tracked_in_epoch() == 0
    finally:
        _reap(loop, list(asyncio.all_tasks(loop)))
        loop.close()


# ----------------------------------------------------- blocking callbacks ----


def test_injected_blocking_callback_is_caught():
    mon = BlockingCallbackMonitor(threshold_s=0.05)
    mon.install()
    try:
        mon.begin_epoch()
        loop = asyncio.new_event_loop()

        async def blocker():
            time.sleep(0.2)  # deliberate block ON the loop thread

        loop.run_until_complete(blocker())
        loop.close()
        reports = mon.reports_in_epoch()
        assert reports, "blocking callback not detected"
        worst = max(reports, key=lambda r: r.duration_s)
        assert worst.duration_s >= 0.05
        assert "time.sleep" in worst.blocked_stack or "blocker" in worst.blocked_stack, \
            worst.render()
    finally:
        mon.uninstall()


def test_blocking_callback_just_over_threshold_has_a_stack():
    """A callback that ends a little past the threshold, before a
    watchdog tick past it, still carries a stack: sampling starts at half
    the threshold.  Its report names the task's coroutine."""
    mon = BlockingCallbackMonitor(threshold_s=0.2)
    mon.install()
    try:
        mon.begin_epoch()
        loop = asyncio.new_event_loop()

        async def just_over():
            await asyncio.sleep(0)
            time.sleep(0.21)

        loop.run_until_complete(just_over())
        loop.close()
        (report,) = [r for r in mon.reports_in_epoch() if r.duration_s >= 0.2]
        assert "just_over" in report.blocked_stack, report.render()
        assert "just_over" in report.where, report.where
    finally:
        mon.uninstall()


def test_blocking_callback_reports_its_gc_time():
    """Collections inside a blocking callback are counted beside it."""
    import gc

    mon = BlockingCallbackMonitor(threshold_s=0.05)
    mon.install()
    try:
        mon.begin_epoch()
        loop = asyncio.new_event_loop()

        async def collects():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.1:
                gc.collect()

        loop.run_until_complete(collects())
        loop.close()
        worst = max(mon.reports_in_epoch(), key=lambda r: r.duration_s)
        assert 0 < worst.gc_s <= worst.duration_s
        assert "garbage collector" in worst.render()
    finally:
        mon.uninstall()
    assert mon._on_gc not in gc.callbacks


# ---------------------------------------------------------- transports ----


def test_unclosed_transport_is_caught():
    tracker = TransportTracker()
    tracker.install()
    try:
        tracker.begin_epoch()
        loop = asyncio.new_event_loop()

        async def handler(reader, writer):
            await reader.read()
            writer.close()

        async def dial_and_abandon():
            server = await asyncio.start_server(handler, "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            _, writer = await asyncio.open_connection("127.0.0.1", port)
            return server, writer

        server, writer = loop.run_until_complete(dial_and_abandon())
        leaks = tracker.unclosed_in_epoch()
        assert leaks and tracker.tracked_in_epoch() >= 1
        assert any("test_torch_sanitizer.py" in rec.render(t) for t, rec in leaks)

        async def cleanup():
            await framing.close_writer(writer)
            server.close()
            await server.wait_closed()
            for _ in range(100):
                if not tracker.unclosed_in_epoch():
                    break
                await asyncio.sleep(0.01)

        loop.run_until_complete(cleanup())
        assert tracker.unclosed_in_epoch() == []
        _reap(loop, list(asyncio.all_tasks(loop)))
        loop.close()
    finally:
        tracker.uninstall()


# ------------------------------------------------------- frame protocol ----


def test_frame_state_machine_illegal_sequences():
    m = FrameStateMachine("conn1")
    m.on_write()
    m.on_write()
    m.on_sever()
    with pytest.raises(FrameProtocolError, match="data-after-sever"):
        m.on_write()
    m.on_close()
    with pytest.raises(FrameProtocolError, match="double-close"):
        m.on_close()
    m2 = FrameStateMachine("conn2", strict=False)
    m2.on_close()
    m2.on_close()
    m2.on_write()
    assert len(m2.violations) == 2
    assert any("double-close" in v for v in m2.violations)
    assert any("data-after-close" in v for v in m2.violations)


async def _wire_sequence(fr, *, late: bool):
    """A real socket through framing module ``fr``: one legal frame, a
    close, and (``late``) a frame after the close and a second close."""

    async def handler(reader, writer):
        await reader.read()
        writer.close()

    server = await asyncio.start_server(handler, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    _, writer = await asyncio.open_connection("127.0.0.1", port)
    fr.write_frame(writer, {"op": "legal"})
    await writer.drain()
    await fr.close_writer(writer)
    if late:
        fr.write_frame(writer, {"op": "too-late"})
        await fr.close_writer(writer)
    server.close()
    await server.wait_closed()


@pytest.mark.no_sanitize  # deliberately violates the frame protocol to prove
#                           the guard catches it (a full-mode global guard
#                           would flag this test otherwise)
def test_framing_guard_catches_illegal_wire_sequence():
    """End to end on a real socket through the port's framing: the guard
    records data-after-close and double-close, and counts the frames."""
    guard = FramingGuard()
    guard.install()
    loop = asyncio.new_event_loop()
    try:
        guard.begin_epoch()
        loop.run_until_complete(_wire_sequence(framing, late=True))
        v = guard.violations_in_epoch()
        assert any("data-after" in msg for msg in v), v
        assert any("double-close" in msg for msg in v), v
        assert guard.frames_in_epoch == 2
    finally:
        guard.uninstall()
        _reap(loop, list(asyncio.all_tasks(loop)))
        loop.close()


# ------------------------------------------------------------- the plugin ----


def test_plugin_fails_a_deliberately_leaky_test(monkeypatch):
    """A test body that leaks a live task is flipped from passed to failed
    with the creation traceback; exempt and failing tests are left alone."""
    san = Sanitizer(MODE_LEAKS)  # not installed: driven directly
    loop = asyncio.new_event_loop()
    san.tasks.instrument_loop(loop)
    san.begin_epoch()
    loop.run_until_complete(_leaky_body())
    monkeypatch.setattr(plugin, "_sanitizer", san)

    class FakeReport:
        when = "call"
        passed = True
        outcome = "passed"
        longrepr = None

    class FakeItem:
        fspath = "/tmp/test_leaky_fixture.py"
        nodeid = "test_leaky_fixture.py::test_leaks_a_task"
        marker = None

        def get_closest_marker(self, name):
            return self.marker

    rep = FakeReport()
    plugin.check_report(FakeItem(), None, rep)
    assert rep.outcome == "failed"
    assert "leaked task" in str(rep.longrepr) and "_leaky_body" in str(rep.longrepr)

    monkeypatch.setitem(plugin.LEAK_GRANDFATHERED_FILES, "test_leaky_fixture.py", "a reason")
    rep2 = FakeReport()
    plugin.check_report(FakeItem(), None, rep2)
    assert rep2.outcome == "passed"
    monkeypatch.delitem(plugin.LEAK_GRANDFATHERED_FILES, "test_leaky_fixture.py")

    exempt = FakeItem()
    exempt.marker = object()
    rep3 = FakeReport()
    plugin.check_report(exempt, None, rep3)
    assert rep3.outcome == "passed"

    rep4 = FakeReport()
    rep4.passed, rep4.outcome, rep4.longrepr = False, "failed", "original failure"
    plugin.check_report(FakeItem(), None, rep4)
    assert rep4.longrepr == "original failure"

    _reap(loop, [t for t, _ in san.tasks.pending_in_epoch()])
    loop.close()


def test_grandfathered_files_are_justified():
    for name, why in plugin.LEAK_GRANDFATHERED_FILES.items():
        assert name.startswith("test_torch_") and why.strip(), name


def test_mode_from_env(monkeypatch):
    monkeypatch.delenv("DYNAMO_SANITIZE", raising=False)
    assert mode_from_env() == MODE_LEAKS
    monkeypatch.setenv("DYNAMO_SANITIZE", "0")
    assert mode_from_env() == MODE_OFF
    monkeypatch.setenv("DYNAMO_SANITIZE", "1")
    assert mode_from_env() == MODE_FULL
    monkeypatch.setenv("DYNAMO_SANITIZE", "full")
    assert mode_from_env() == MODE_FULL


def _seams():
    return (ev.BaseDefaultEventLoopPolicy.new_event_loop, ev.Handle._run,
            sel.BaseSelectorEventLoop._make_socket_transport)


def test_full_sanitizer_install_uninstall_roundtrip():
    """MODE_FULL installs all four instruments, and uninstall restores
    every patched seam (policy, Handle._run, _make_socket_transport, the
    port's framing functions)."""
    before, orig_write = _seams(), framing.write_frame
    san = Sanitizer(MODE_FULL).install()
    try:
        assert all(a is not b for a, b in zip(_seams(), before))
        assert framing.write_frame is not orig_write
        assert san.epoch_report() == []
    finally:
        san.uninstall()
    assert _seams() == before and framing.write_frame is orig_write


# ----------------------------------------- beside the JAX package's sanitizer ----


def test_both_sanitizers_nest_and_guard_only_their_own_package():
    """The JAX sanitizer, then the port's, both in full mode: each framing
    guard wraps only its own package's modules; the port's uninstall
    leaves the JAX patches exactly as they were, and the JAX uninstall
    brings back the originals."""
    before = _seams()
    originals = {m: (m.write_frame, m.close_writer) for m in (framing, tcp, jax_framing, jax_tcp)}
    jax = jax_san.Sanitizer(jax_san.MODE_FULL).install()
    try:
        with_jax = _seams()
        jax_wrapped = {m: (m.write_frame, m.close_writer) for m in originals}
        assert jax_wrapped[framing] == originals[framing] and jax_wrapped[tcp] == originals[tcp]
        assert jax_wrapped[jax_framing] != originals[jax_framing]
        port = Sanitizer(MODE_FULL).install()
        try:
            assert all(a is not b for a, b in zip(_seams(), with_jax))
            for m in (framing, tcp):
                assert m.write_frame is not originals[m][0]
                assert m.close_writer is not originals[m][1]
            for m in (jax_framing, jax_tcp):
                assert (m.write_frame, m.close_writer) == jax_wrapped[m]
            loop = asyncio.new_event_loop()
            try:
                port.begin_epoch()
                loop.run_until_complete(_wire_sequence(framing, late=False))
                assert port.framing.frames_in_epoch == 1
                assert port.framing.violations_in_epoch() == []
                assert port.tasks.tracked_in_epoch() >= 1
            finally:
                _reap(loop, list(asyncio.all_tasks(loop)))
                loop.close()
        finally:
            port.uninstall()
        assert _seams() == with_jax
        assert {m: (m.write_frame, m.close_writer) for m in originals} == jax_wrapped
    finally:
        jax.uninstall()
    assert _seams() == before
    assert {m: (m.write_frame, m.close_writer) for m in originals} == originals


def test_out_of_order_uninstall_is_refused():
    """Installed under the JAX tracker's later patch, the port's tracker
    refuses to uninstall first (it would drop the JAX patch); after the
    JAX uninstall it restores the original."""
    before = ev.BaseDefaultEventLoopPolicy.new_event_loop
    port = TaskTracker()
    port.install()
    jax = jax_san.TaskTracker()
    jax.install()
    try:
        with pytest.raises(RuntimeError, match="out of order"):
            port.uninstall()
        assert port.installed
    finally:
        jax.uninstall()
        port.uninstall()
    assert ev.BaseDefaultEventLoopPolicy.new_event_loop is before


# ----------------------------------------------------- the standalone plugin ----


_LEAKY = '''
import asyncio


def test_leaks_a_task():
    loop = asyncio.new_event_loop()

    async def spawns_and_returns():
        asyncio.ensure_future(asyncio.sleep(60))
        await asyncio.sleep(0)

    loop.run_until_complete(spawns_and_returns())


def test_clean():
    async def reaps():
        t = asyncio.ensure_future(asyncio.sleep(60))
        await asyncio.sleep(0)
        t.cancel()
        await asyncio.gather(t, return_exceptions=True)

    asyncio.run(reaps())
'''

_FRAMES = '''
import asyncio

from {pkg}.runtime.transports import framing


async def _sequence(late):
    async def handler(reader, writer):
        await reader.read()
        writer.close()

    server = await asyncio.start_server(handler, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    _, writer = await asyncio.open_connection("127.0.0.1", port)
    framing.write_frame(writer, {{"op": "legal"}})
    await writer.drain()
    await framing.close_writer(writer)
    if late:
        framing.write_frame(writer, {{"op": "too-late"}})
    server.close()
    await server.wait_closed()


def test_frame_after_close():
    asyncio.run(_sequence(True))


def test_frames_in_order():
    asyncio.run(_sequence(False))
'''


def _run_plugin(tmp_path, files: dict, **env) -> subprocess.CompletedProcess:
    for name, text in files.items():
        (tmp_path / name).write_text(textwrap.dedent(text))
    run_env = dict(os.environ, PYTHONPATH=str(ROOT), **env)
    return subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", plugin.__name__,
         "-p", "no:cacheprovider", "-q", "-rf", str(tmp_path)],
        cwd=tmp_path, env=run_env, capture_output=True, text=True, timeout=120)


def test_standalone_plugin_fails_a_leak_with_its_traceback(tmp_path):
    res = _run_plugin(tmp_path, {"test_leaky.py": _LEAKY}, DYNAMO_SANITIZE="leaks")
    out = res.stdout + res.stderr
    assert res.returncode == 1, out
    assert "1 failed, 1 passed" in out, out
    assert "FAILED test_leaky.py::test_leaks_a_task" in out, out
    assert "dtsan found 1 issue" in out and "leaked task" in out, out
    assert "spawns_and_returns" in out and "test_leaky.py" in out, out


def test_standalone_plugin_full_mode_fails_a_frame_after_close(tmp_path):
    res = _run_plugin(tmp_path, {"test_frames.py": _FRAMES.format(pkg=dynamo_tpu_torch.__name__)},
                      DYNAMO_SANITIZE="1")
    out = res.stdout + res.stderr
    assert res.returncode == 1, out
    assert "1 failed, 1 passed" in out, out
    assert "FAILED test_frames.py::test_frame_after_close" in out, out
    assert "data-after-close" in out, out
