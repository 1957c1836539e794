"""The load generator: a process of its own, so that the client's clock
and threads share nothing with the server's. It reads one JSON object on
standard input (``port``, ``model``, ``t0`` the window's start on the
system's monotonic clock, ``seconds``, ``wait_s`` and the generator's
``plan``), sends streamed ``/v1/completions`` requests whose prompts are
token-id lists, and writes one JSON object on standard output: a record
for every request it sent, with the monotonic time it was due, sent, and
each token's arrival, its tokens and logprobs, and its status.

An open plan sends each request at ``t0 + due`` whatever came before; a
closed plan runs one thread a worker that sends its next request when the
last is answered and sends none once the window has closed. Requests in
flight at the close are waited for up to ``wait_s`` seconds; one that has
no answer by then is recorded as failed.

    python3 portbench/loadgen.py < request.json > records.json
"""

from __future__ import annotations

import http.client
import json
import sys
import threading
import time


def stream(port: int, body: dict, rec: dict, timeout: float) -> None:
    """One streamed completion into ``rec``: token arrival times, ids and
    logprobs, ``status`` "ok" or the failure."""
    rec["token_times"], rec["tokens"], rec["lps"] = [], [], []
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        rec["sent"] = time.monotonic()
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            rec["status"] = f"http {resp.status}: {resp.read()[:200]!r}"
            conn.close()
            return
        buf = b""
        finished = False
        while not finished:
            chunk = resp.read1(65536)
            if not chunk:
                break
            now = time.monotonic()
            buf += chunk
            while b"\n\n" in buf and not finished:
                frame, buf = buf.split(b"\n\n", 1)
                for line in frame.split(b"\n"):
                    if not line.startswith(b"data: "):
                        continue
                    data = line[6:]
                    if data == b"[DONE]":
                        finished = True
                        break
                    msg = json.loads(data)
                    if "error" in msg:
                        raise RuntimeError(f"error frame: {msg['error']}")
                    choice = msg["choices"][0]
                    for tok in choice.get("tokens") or ():
                        rec["token_times"].append(now)
                        rec["tokens"].append(int(tok))
                        lps = (choice.get("logprobs") or {}).get("token_logprobs") or [None]
                        rec["lps"].append(lps[0])
        conn.close()
        rec["status"] = "ok" if finished else "stream ended before [DONE]"
    except Exception as exc:  # noqa: BLE001 - every failure is a recorded miss
        rec["status"] = f"{type(exc).__name__}: {exc}"
    finally:
        rec["done"] = time.monotonic()


def body_for(model: str, prompt: list, max_tokens: int) -> dict:
    """A greedy streamed completion with the chosen tokens' logprobs."""
    return {"model": model, "prompt": prompt, "max_tokens": max_tokens, "temperature": 0,
            "logprobs": 1, "stream": True}


def run_open(req: dict, records: list) -> list:
    t0, port, model = req["t0"], req["port"], req["model"]
    threads = []
    for i, r in enumerate(req["plan"]["requests"]):
        due = t0 + r["due"]
        delay = due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        rec = {"i": i, "due": due, "prompt_len": len(r["prompt"]),
               "max_tokens": r["max_tokens"], "status": "pending"}
        records.append(rec)
        t = threading.Thread(target=stream, daemon=True,
                             args=(port, body_for(model, r["prompt"], r["max_tokens"]), rec,
                                   req["seconds"] + req["wait_s"] + 600))
        t.start()
        threads.append(t)
    return threads


def run_closed(req: dict, records: list) -> list:
    t0, port, model = req["t0"], req["port"], req["model"]
    end = t0 + req["seconds"]
    lock = threading.Lock()
    start = t0 - req["plan"]["warm_s"]

    def worker(w: int, sessions: list) -> None:
        delay = start - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        for s, session in enumerate(sessions):
            for q, question in enumerate(session["questions"]):
                if time.monotonic() >= end:
                    return
                prompt = session["doc"] + question["suffix"]
                rec = {"worker": w, "session": s, "q": q, "doc_len": len(session["doc"]),
                       "prompt_len": len(prompt), "max_tokens": question["max_tokens"],
                       "status": "pending", "due": None}
                with lock:
                    rec["i"] = len(records)
                    records.append(rec)
                stream(port, body_for(model, prompt, question["max_tokens"]), rec,
                       req["seconds"] + req["wait_s"] + 600)

    threads = [threading.Thread(target=worker, args=(w, sessions), daemon=True)
               for w, sessions in enumerate(req["plan"]["workers"])]
    for t in threads:
        t.start()
    return threads


def main() -> int:
    req = json.load(sys.stdin)
    records: list = []
    run = run_open if req["plan"]["mode"] == "open" else run_closed
    threads = run(req, records)
    deadline = req["t0"] + req["seconds"] + req["wait_s"]
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    out = [dict(r) for r in list(records)]  # threads still waiting go on writing theirs
    for rec in out:
        if rec["status"] == "pending":
            rec["status"] = f"no answer {req['wait_s']} s after the window closed"
            rec["done"] = deadline
            rec.setdefault("sent", rec["due"])
    json.dump({"records": out, "late_s": lateness(out)}, sys.stdout)
    sys.stdout.flush()
    return 0


def lateness(records: list) -> float:
    """How late the generator sent its latest request, in seconds (an open
    loop's schedule slipping on the client's side)."""
    late = [r["sent"] - r["due"] for r in records
            if r.get("sent") is not None and r.get("due") is not None]
    return max(late, default=0.0)


if __name__ == "__main__":
    sys.exit(main())
