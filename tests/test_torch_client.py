"""The port's client library (``mygramdb_tpu_torch.client``) and its CLI's
one-shot mode against the port's in-process TCP server: the cases of
``tests/test_client.py``, repeated ones merged into parametrised tests."""

import asyncio
import threading

import pytest

from mygramdb_tpu_torch.catalog import TableCatalog
from mygramdb_tpu_torch.client import (MygramClient, MygramClientError,
                                       SearchExpression)
from mygramdb_tpu_torch.config import load_config_from_dict
from mygramdb_tpu_torch.server.core import ServerCore
from mygramdb_tpu_torch.server.tcp_server import TcpServer

from test_client import CFG
from torch_parity import torch_cpu  # noqa: F401


@pytest.fixture(scope="module")
def server(torch_cpu):
    """The port's asyncio TCP server on a background thread."""
    holder = {}
    started = threading.Event()

    async def main():
        cfg = load_config_from_dict(CFG)
        cat = TableCatalog(cfg)
        ctx = cat.resolve("articles")
        for pk, text, f in [
                ("1", "hello world", {"status": 1, "category": "a"}),
                ("2", "hello there", {"status": 2, "category": "b"}),
                ("3", "goodbye world", {"status": 1, "category": "a"})]:
            ctx.add_row(pk, text, f)
        srv = TcpServer(ServerCore(cfg, cat), cfg)
        await srv.start()
        holder["port"] = srv.port
        holder["stop"] = asyncio.get_running_loop().create_future()
        started.set()
        await holder["stop"]
        await srv.stop()

    t = threading.Thread(target=lambda: asyncio.run(main()), daemon=True)
    t.start()
    assert started.wait(30)
    yield holder
    holder["stop"].get_loop().call_soon_threadsafe(
        holder["stop"].set_result, None)
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.mark.parametrize("call, want", [
    (lambda c: (lambda r: (r.total, r.ids))(c.search("articles", "hello")),
     (2, ["2", "1"])),
    (lambda c: c.search("articles", "world", filters=["status = 1"],
                        sort="id ASC").ids, ["1", "3"]),
    (lambda c: (c.count("articles", "world"),
                (lambda d: (d["_pk"], d["status"]))(c.get("articles", "2"))),
     (2, ("2", "2"))),
    (lambda c: c.facet("articles", "category", "world"), {"a": 2}),
    (lambda c: c.info()["engine"], "mygramdb-tpu"),
    (lambda c: c.show_variables("cache.enabled").get("cache.enabled")
     in ("ON", "OFF"), True),
    (lambda c: [c.count("articles", "hello") for _ in range(5)], [2] * 5),
], ids=["search", "search_filters_sort", "count_get", "facet", "info",
        "show_variables", "multiple_commands_one_connection"])
def test_client_calls(server, call, want):
    with MygramClient(port=server["port"]) as c:
        assert call(c) == want


def test_error(server):
    with MygramClient(port=server["port"]) as c:
        with pytest.raises(MygramClientError, match="Table not found"):
            c.search("nope", "x")


def test_highlights(server):
    with MygramClient(port=server["port"]) as c:
        r = c.search_with_highlights("articles", "hello",
                                     open_tag="<b>", close_tag="</b>")
        assert r.total == 2
        assert "<b>hello</b>" in r.snippets[r.ids[0]]


@pytest.mark.parametrize("expr, line", [
    (SearchExpression("articles").query("hello world").and_term("fast")
     .not_term("slow").filter("status", "=", 1).sort("_score").limit(10)
     .offset(5),
     'SEARCH articles "hello world" AND fast NOT slow FILTER status = 1 '
     'SORT _score DESC LIMIT 10 OFFSET 5'),
    (SearchExpression("t").query("x").limit(5).as_count(), "COUNT t x"),
], ids=["build", "count_mode"])
def test_expression_build(expr, line):
    assert expr.build() == line


def test_expression_roundtrip(server):
    with MygramClient(port=server["port"]) as c:
        expr = (SearchExpression("articles").query("hello")
                .filter("status", "=", 1))
        assert c.command(expr.build()) == "OK RESULTS 1 1"


@pytest.mark.parametrize("argv, rc, out", [
    (["-e", "SEARCH articles hello"], 0, "OK RESULTS 2 2 1"),
    (["-e", "SEARCH nope x"], 1, None),
    (["-e", "INFO"], 2, None),
], ids=["execute_flag", "execute_error", "connect_failure"])
def test_cli_one_shot(server, capsys, argv, rc, out):
    from mygramdb_tpu_torch.cli.repl import main
    port = "1" if rc == 2 else str(server["port"])
    assert main(["-p", port] + argv) == rc
    if out is not None:
        assert out in capsys.readouterr().out
