"""Interactive CLI (reference cli/mygram-cli.cpp).

    mygram-tpu-cli [-h HOST] [-p PORT] [-s UNIX_SOCKET] [-e "COMMAND"]

Features: readline history + command/keyword completion, multi-line
response rendering, exit-code mapping (0 ok, 1 error response,
2 connection failure) matching the reference CLI behavior.
"""

from __future__ import annotations

import argparse
import sys

from ..client import MygramClient, MygramClientError

COMMANDS = [
    "SEARCH", "COUNT", "GET", "INFO", "FACET", "DUMP SAVE", "DUMP LOAD",
    "DUMP VERIFY", "DUMP INFO", "DUMP STATUS", "REPLICATION STATUS",
    "REPLICATION STOP", "REPLICATION START", "SYNC", "SYNC STATUS",
    "SYNC STOP", "CONFIG SHOW", "CONFIG HELP", "CONFIG VERIFY", "OPTIMIZE",
    "DEBUG ON", "DEBUG OFF", "CACHE CLEAR", "CACHE STATS", "CACHE ENABLE",
    "CACHE DISABLE", "SET", "SHOW VARIABLES", "QUIT",
]
KEYWORDS = ["AND", "NOT", "FILTER", "SORT", "LIMIT", "OFFSET", "HIGHLIGHT",
            "FUZZY", "ASC", "DESC", "LIKE", "TAG"]


def _setup_readline() -> None:
    try:
        import readline
    except ImportError:
        return

    words = sorted(set(
        w for c in COMMANDS for w in c.split()) | set(KEYWORDS))

    def complete(text, state):
        matches = [w for w in words if w.startswith(text.upper())]
        return matches[state] if state < len(matches) else None

    readline.set_completer(complete)
    readline.parse_and_bind("tab: complete")


def _needs_multiline(line: str, debug_on: bool) -> bool:
    """Blank-line-framed responses the client can't infer from the
    first-line prefix: HIGHLIGHT snippets and DEBUG-mode search/count
    blocks (DEBUG ON/OFF themselves answer a single line)."""
    up = line.strip().upper()
    if "HIGHLIGHT" in up:
        return True
    return debug_on and up.startswith(("SEARCH", "COUNT", "FACET"))


def run_command(client: MygramClient, line: str,
                state: dict = None) -> int:
    state = state if state is not None else {}
    try:
        resp = client.command(
            line, expect_multiline=_needs_multiline(
                line, state.get("debug", False)))
    except (MygramClientError, OSError) as e:
        print(f"connection error: {e}", file=sys.stderr)
        return 2
    if resp.startswith("OK DEBUG_ON"):
        state["debug"] = True
    elif resp.startswith("OK DEBUG_OFF"):
        state["debug"] = False
    print(resp)
    return 1 if resp.startswith("ERROR") else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mygram-tpu-cli",
                                 description="MygramDB-TPU interactive CLI")
    ap.add_argument("-H", "--host", default="127.0.0.1")
    ap.add_argument("-p", "--port", type=int, default=11016)
    ap.add_argument("-s", "--socket", default="",
                    help="Unix domain socket path")
    ap.add_argument("-e", "--execute", default="",
                    help="execute one command and exit")
    ap.add_argument("-t", "--timeout", type=float, default=30.0)
    args = ap.parse_args(argv)

    client = MygramClient(args.host, args.port, timeout=args.timeout,
                          unix_socket=args.socket)
    try:
        client.connect()
    except OSError as e:
        print(f"cannot connect to "
              f"{args.socket or f'{args.host}:{args.port}'}: {e}",
              file=sys.stderr)
        return 2

    if args.execute:
        rc = run_command(client, args.execute)
        client.close()
        return rc

    _setup_readline()
    print("mygram-tpu-cli — type commands, QUIT to exit")
    rc = 0
    state: dict = {}
    while True:
        try:
            line = input("mygram> ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if not line:
            continue
        if line.upper() in ("QUIT", "EXIT"):
            break
        rc = run_command(client, line, state)
        if rc == 2:
            break
    client.close()
    return rc if rc == 2 else 0


if __name__ == "__main__":
    sys.exit(main())
