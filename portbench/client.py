"""The client process of the closed loop: ``python3 client.py ARGS.json``.

One thread drives every connection through a selector, on the CPUs named
in ARGS (none of the server's). It opens its connections to the server and
says ``ready`` on standard output. On ``go`` (standard input) each
connection sends its next query when the previous answer has arrived: the
queries of its warm list first, shared among its connections, then from its
own place in the replayed list; once the warm list has been answered, it
says ``warm``. On ``window T0 T1`` (times on the
host's monotonic clock, which every process shares) it counts the answers
that arrive inside [T0, T1] and stops at T1. Latency is taken from the send
to the whole answer. It writes the window's latencies and every distinct
answer of each query, plus the queries that failed (an ERROR answer, a
timeout or a lost connection), to the output file named in ARGS, and says
``done``.

It imports nothing but the standard library, and is started as a new
interpreter, so it shares neither the server's interpreter lock nor its
CUDA context; one thread keeps the load generator's own use of the
machine small.
"""

import json
import os
import selectors
import socket
import sys
import time

BANNED = ("jax", "jaxlib", "flax", "mygramdb_tpu")


class Conn:
    def __init__(self, port: int, start: int, timeout: float):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.setblocking(False)
        self.k = start
        self.warming = False
        self.qi = -1
        self.t_send = 0.0
        self.buf = b""


def main(argv) -> int:
    with open(argv[0]) as fh:
        a = json.load(fh)
    if a["cpus"]:
        os.sched_setaffinity(0, a["cpus"])
    with open(a["queries"]) as fh:
        lines = [(line + "\r\n").encode() for line in json.load(fh)]
    order, timeout = a["order"], a["timeout_s"]
    conns = [Conn(a["port"], s, timeout) for s in a["starts"]]
    warm_list = list(reversed(a["warm"]))
    print("ready", flush=True)
    if sys.stdin.readline().split() != ["go"]:
        return 1
    t0 = t1 = float("inf")
    warm = False
    lat, at, qis, failed, answers = [], [], [], [], {}
    sel = selectors.DefaultSelector()
    sel.register(sys.stdin, selectors.EVENT_READ, None)

    def send(c: Conn) -> None:
        c.warming = bool(warm_list)
        if c.warming:
            c.qi = warm_list.pop()
        else:
            c.qi = int(order[c.k % len(order)])
            c.k += 1
        c.t_send = time.monotonic()
        c.sock.setblocking(True)   # a query line is far below the buffer
        c.sock.sendall(lines[c.qi])
        c.sock.setblocking(False)

    def close(c: Conn) -> None:
        sel.unregister(c.sock)
        c.sock.close()

    for c in conns:
        sel.register(c.sock, selectors.EVENT_READ, c)
        send(c)
    live = len(conns)
    while live:
        events = sel.select(timeout=0.5)
        for key, _ in events:
            c = key.data
            if c is None:  # window T0 T1
                words = sys.stdin.readline().split()
                sel.unregister(sys.stdin)
                if len(words) != 3 or words[0] != "window":
                    return 1
                t0, t1 = float(words[1]), float(words[2])
                continue
            try:
                data = c.sock.recv(1 << 16)
            except BlockingIOError:
                continue
            except OSError:
                data = b""
            c.buf += data
            if data and b"\r\n" not in c.buf:
                continue  # the rest of the answer is on its way
            t_recv = time.monotonic()
            answer, _, c.buf = c.buf.partition(b"\r\n")
            if t0 <= t_recv <= t1:
                if data and answer.startswith(b"OK"):
                    lat.append(t_recv - c.t_send)
                    at.append(t_recv - t0)
                    qis.append(c.qi)
                    answers.setdefault(c.qi, set()).add(answer.decode())
                else:
                    failed.append([c.qi, answer.decode(errors="replace")
                                   or "no answer"])
            if not data or t_recv >= t1:
                close(c)
                live -= 1
            else:
                send(c)
            if not warm and not warm_list and not any(
                    x.warming for x in conns):
                warm = True
                print("warm", flush=True)
        now = time.monotonic()
        for key in list(sel.get_map().values()):  # answers that never came
            c = key.data
            if c is not None and now - c.t_send > timeout:
                if c.t_send + timeout <= t1:
                    failed.append([c.qi, "timeout"])
                close(c)
                live -= 1
    out = {"lat": lat, "at": at, "qi": qis,
           "answers": {str(k): sorted(v) for k, v in answers.items()},
           "failed": failed,
           "banned_modules": sorted(m for m in sys.modules
                                    if m.split(".")[0] in BANNED)}
    with open(a["out"], "w") as fh:
        json.dump(out, fh)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
