"""Closed-loop HTTP clients in a process of their own, apart from the
server's, as a deployment's clients are.

    python3 port_bench/loadgen.py

Reads a pickled plan on stdin (``port``, ``seconds``, ``plan``: one list
of ``(body, speaker)`` a client), prints ``ready``, waits for a line
``go <t0>`` (``t0`` on the system's monotonic clock, which the parent
shares) and runs one thread a client: each posts its next body to
``/convert`` when its last reply has come, and sends nothing once
``seconds`` have passed since ``t0``.  When every reply is in, it writes
the pickled list of requests to stdout: client, index, the monotonic
times the POST was sent and its reply's last byte came, the seconds its
TCP connection took, success, the reply, the body's index and its
speaker.  Imports nothing but the standard library.
"""

from __future__ import annotations

import http.client
import pickle
import sys
import threading
import time


def _client(i, port, plan, t0, seconds, out, lock):
    k = 0
    while time.monotonic() - t0 < seconds:
        body, spk = plan[k % len(plan)]
        t_send = time.monotonic()
        reply, ok, t_conn = b"", False, float("nan")
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            conn.connect()
            t_conn = time.monotonic()
            conn.request("POST", f"/convert?trg_spk={spk}", body, {"Content-Type": "audio/wav"})
            resp = conn.getresponse()
            reply = resp.read()
            ok = resp.status == 200
            conn.close()
        except (OSError, http.client.HTTPException):
            ok = False
        t_reply = time.monotonic()
        with lock:
            out.append({"client": i, "k": k, "t0": t_send, "t1": t_reply, "ok": ok,
                        "connect_s": t_conn - t_send,
                        "reply": reply, "body_index": k % len(plan), "spk": spk})
        k += 1


def main() -> int:
    spec = pickle.load(sys.stdin.buffer)
    print("ready", flush=True)
    word, t0 = sys.stdin.readline().split()
    if word != "go":
        return 2
    t0 = float(t0)
    out, lock = [], threading.Lock()
    threads = [threading.Thread(target=_client, args=(i, spec["port"], plan, t0,
                                                     spec["seconds"], out, lock))
               for i, plan in enumerate(spec["plan"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    pickle.dump(out, sys.stdout.buffer)
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
