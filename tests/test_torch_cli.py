"""The port's CLI (``mygramdb_tpu_torch.cli.repl``) against the port's
server: the cases of ``tests/test_cli.py`` (one-shot -e execution with
exit-code mapping, the REPL loop over a live server), repeated ones merged
into parametrised tests."""

import asyncio
import io
import threading

import pytest

from mygramdb_tpu_torch.catalog import TableCatalog
from mygramdb_tpu_torch.config import load_config_from_dict
from mygramdb_tpu_torch.server.core import ServerCore
from mygramdb_tpu_torch.server.tcp_server import TcpServer

from test_cli import CFG
from torch_parity import torch_cpu  # noqa: F401


@pytest.fixture()
def live_port(torch_cpu):
    cfg = load_config_from_dict(CFG)
    cat = TableCatalog(cfg)
    ctx = cat.resolve("t")
    ctx.add_row("1", "hello world", {})
    ctx.add_row("2", "goodbye world", {})
    core = ServerCore(cfg, cat)
    loop = asyncio.new_event_loop()
    srv = TcpServer(core, cfg)
    started = threading.Event()

    async def run():
        await srv.start()
        started.set()
        await stop_ev.wait()
        await srv.stop()

    stop_ev = None

    def runner():
        nonlocal stop_ev
        asyncio.set_event_loop(loop)
        stop_ev = asyncio.Event()
        loop.run_until_complete(run())

    th = threading.Thread(target=runner, daemon=True)
    th.start()
    assert started.wait(20)
    yield srv.port
    loop.call_soon_threadsafe(stop_ev.set)
    th.join(20)
    assert not th.is_alive()


def run_cli(argv, stdin_text=""):
    import sys
    from mygramdb_tpu_torch.cli import repl
    old_in, old_out, old_err = sys.stdin, sys.stdout, sys.stderr
    sys.stdin = io.StringIO(stdin_text)
    sys.stdout = io.StringIO()
    sys.stderr = io.StringIO()
    try:
        rc = repl.main(argv)
        return rc, sys.stdout.getvalue(), sys.stderr.getvalue()
    finally:
        sys.stdin, sys.stdout, sys.stderr = old_in, old_out, old_err


@pytest.mark.parametrize("command, rc, check", [
    ("SEARCH t hello", 0, lambda out: out.startswith("OK RESULTS 1 1")),
    ("SEARCH missing hello", 1, lambda out: out.startswith("ERROR")),
    ("DEBUG ON", 0, lambda out: out.strip() == "OK DEBUG_ON"),
    ("INFO", 0, lambda out: out.rstrip().endswith("END")),
], ids=["execute_ok", "execute_error_maps_rc1", "debug_on_single_line",
        "info_end_framed"])
def test_one_shot(live_port, command, rc, check):
    got_rc, out, _ = run_cli(["-p", str(live_port), "-e", command])
    assert got_rc == rc
    assert check(out)


def test_connection_failure_maps_rc2():
    rc, _out, err = run_cli(["-p", "1", "-e", "INFO"])
    assert rc == 2
    assert "cannot connect" in err


@pytest.mark.parametrize("stdin_text, wants", [
    ("SEARCH t world\nCOUNT t hello\nQUIT\n",
     ["OK RESULTS 2", "OK COUNT 1"]),
    ("", []),
    # DEBUG ON -> debug-framed SEARCH (leading-blank body) -> DEBUG OFF ->
    # a normal command still answers correctly (a framing bug here leaves
    # the debug body unread and desyncs the wire)
    ("DEBUG ON\nSEARCH t hello\nDEBUG OFF\nCOUNT t world\nQUIT\n",
     ["OK DEBUG_ON", "# DEBUG", "OK DEBUG_OFF", "OK COUNT 2"]),
], ids=["repl_session", "repl_eof_exits_cleanly",
        "repl_debug_session_no_desync"])
def test_repl(live_port, stdin_text, wants):
    rc, out, _ = run_cli(["-p", str(live_port)], stdin_text=stdin_text)
    assert rc == 0
    for w in wants:
        assert w in out
