"""Open-loop HTTP load generator, run as a child process.

    python3 loadgen.py < schedule.json > results.json

The schedule is `{"port": p, "requests": [{"at": s, "body": {...}}, ...],
"keep": [i, ...], "timeout_s": t}`.  Once started, it prints `ready` and
waits for a line on stdin; it then sends request i at `at` seconds after
that line arrived (time.perf_counter's clock, which the parent shares), each
on its own connection from a thread pool, whatever the earlier requests'
state: an open loop.  It writes one JSON object: for every request its
scheduled, sent and done times (absolute, on that clock), its HTTP status
and its body's length, and for the requests in `keep` the WAV body's PCM16
samples, base64.  It imports the standard library alone, so its clock
shares no interpreter lock with the server's threads.
"""

import base64
import http.client
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor


def _send(port, body, timeout):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        payload = json.dumps(body)
        conn.request("POST", "/synthesize", payload, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data
    finally:
        conn.close()


def main() -> int:
    spec = json.loads(sys.stdin.readline())
    reqs, keep = spec["requests"], set(spec.get("keep", []))
    port, timeout = spec["port"], float(spec.get("timeout_s", 120.0))
    out = [{"status": 0, "bytes": 0} for _ in reqs]
    pcm = {}
    lock = threading.Lock()
    print("ready", flush=True)
    sys.stdin.readline()
    t0 = time.perf_counter()

    def one(i):
        rec = out[i]
        rec["sent"] = time.perf_counter()
        try:
            status, data = _send(port, reqs[i]["body"], timeout)
        except OSError as e:
            rec["error"] = f"{type(e).__name__}: {e}"
            status, data = 0, b""
        rec["done"] = time.perf_counter()
        rec["status"], rec["bytes"] = status, len(data)
        if i in keep and status == 200:
            with lock:
                pcm[str(i)] = base64.b64encode(data[44:]).decode()

    with ThreadPoolExecutor(max_workers=int(spec.get("max_in_flight", 512))) as pool:
        futures = []
        for i, r in enumerate(reqs):
            due = t0 + r["at"]
            out[i]["due"] = due
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            futures.append(pool.submit(one, i))
        for f in futures:
            f.result()
    json.dump({"t0": t0, "requests": out, "pcm": pcm}, sys.stdout)
    sys.stdout.write("\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
