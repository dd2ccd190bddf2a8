"""Concurrent load generator for ``scripts/serve.py --http`` (a copy of the
JAX package's ``scripts/load_test.py``: a standard-library HTTP client).

Drives POST /caption at fixed offered loads (open loop: request start times
are scheduled, not gated on completions, so queueing delay is measured) and
reports the latency distribution (p50, p95, p99), throughput and errors for
each offered rate, one JSON line per rate.

    python -m style_seqcvae_tpu_torch.scripts.serve --http 8732 \\
        --canvas 608 928 --batch-requests 8 --config ... &
    python -m style_seqcvae_tpu_torch.scripts.load_test \\
        --url http://127.0.0.1:8732 --image img.jpg --rates 5 15 --duration 20
"""

import argparse
import json
import threading
import time
import urllib.request
from typing import Dict, List, Optional

import numpy as np

parser = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
parser.add_argument("--url", default="http://127.0.0.1:8732")
parser.add_argument("--image", required=True, help="image file POSTed by every request")
parser.add_argument("--rates", type=float, nargs="+", default=[5.0, 15.0],
                    help="offered loads (requests/second)")
parser.add_argument("--duration", type=float, default=20.0, help="seconds per rate")
parser.add_argument("--timeout", type=float, default=120.0)
parser.add_argument("--sentiment", type=float, default=1.0)
parser.add_argument("--output", default="")


def run_rate(url, payload, rate, duration, timeout, sentiment) -> Dict[str, float]:
    """Open loop: one thread per scheduled request (arrival times fixed up
    front), latencies measured from the scheduled start."""
    n = max(int(rate * duration), 1)
    arrivals = np.sort(np.random.RandomState(0).uniform(0, duration, n))
    results = [None] * n

    def fire(i):
        t0 = time.time()
        try:
            req = urllib.request.Request(f"{url}/caption?sentiment={sentiment}", data=payload,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                body = json.loads(resp.read())
                results[i] = {"ok": True, "s": time.time() - t0, "batch": body.get("batch", 1)}
        except Exception as e:
            results[i] = {"ok": False, "s": time.time() - t0, "error": f"{type(e).__name__}"}

    threads = []
    t_start = time.time()
    for i, at in enumerate(arrivals):
        delay = t_start + at - time.time()
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=fire, args=(i,))
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    wall = time.time() - t_start

    oks = [r for r in results if r and r["ok"]]
    lat = np.array([r["s"] for r in oks]) * 1000.0
    out = {"offered_rps": rate, "requests": n, "ok": len(oks), "errors": n - len(oks),
           "achieved_rps": round(len(oks) / wall, 2)}
    if len(oks):
        out.update({
            "p50_ms": round(float(np.percentile(lat, 50)), 1),
            "p95_ms": round(float(np.percentile(lat, 95)), 1),
            "p99_ms": round(float(np.percentile(lat, 99)), 1),
            "max_ms": round(float(lat.max()), 1),
            "mean_batch": round(float(np.mean([r["batch"] for r in oks])), 2),
        })
    return out


def main(argv: Optional[List[str]] = None) -> List[Dict[str, float]]:
    """Run the load test on ``argv`` (``sys.argv[1:]`` when None); prints and
    returns one row per rate."""
    args = parser.parse_args(argv)
    with open(args.image, "rb") as f:
        payload = f.read()

    # one warm probe so that the first rate's first request does not measure
    # the server's start
    run_rate(args.url, payload, 1.0, 1.0, args.timeout, args.sentiment)

    rows = []
    for rate in args.rates:
        row = run_rate(args.url, payload, rate, args.duration, args.timeout, args.sentiment)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
