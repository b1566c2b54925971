#!/usr/bin/env python3
"""Cluster start-up time of ray_tpu_torch's runtime in its default shape
(GCS and raylet on the driver's IO loop, workers forked by the worker
factory), measured on the host it runs on:

    python3 scripts/torch_runtime_init_time.py [--runs 3]

Per run, in seconds: ``init()`` to its return, the first task's round trip
after it (it waits for a worker to start), ten more task round trips, and
``shutdown()``. Prints one JSON object; the medians are over the runs. The
runs declare ``num_gpus=1`` and start no GPU work, so the script runs the
same on a host with or without a card.
"""

import argparse
import json
import os
import statistics
import sys
import time


def one_run(rt):
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1)
    t1 = time.perf_counter()

    @rt.remote
    def ping():
        return os.getpid()

    rt.get(ping.remote(), timeout=120)
    t2 = time.perf_counter()
    for _ in range(10):
        rt.get(ping.remote(), timeout=120)
    t3 = time.perf_counter()
    rt.shutdown()
    t4 = time.perf_counter()
    return {"init_s": t1 - t0, "first_task_s": t2 - t1,
            "task_round_trip_ms": 1e3 * (t3 - t2) / 10,
            "shutdown_s": t4 - t3}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import ray_tpu_torch as rt

    runs = [one_run(rt) for _ in range(args.runs)]
    print(json.dumps({
        "host_cpus": os.cpu_count(), "runs": runs,
        "median": {k: statistics.median(r[k] for r in runs)
                   for k in runs[0]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
