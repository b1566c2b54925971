#!/usr/bin/env python3
"""Actor start-up times across the whole chip smoke, on the card:

    python3 scripts/torch_actor_start_times.py [--out PATH]

Runs ``chip_smoke.main()`` in this process, where every ``init()`` of the
smoke starts its GCS and raylet, and times each actor creation there: from
the raylet's ``start_actor`` (the GCS's placement request) to its reply,
which comes after the worker has run the constructor and reported ALIVE,
and within it the wait for a worker (``_pop_worker``). Each creation is
tagged with the smoke's last phase line before it. While a creation has
taken more than 6 s, the driver's threads are sampled every 2 s (name and
innermost frames), to tell a busy control plane from a slow worker.

Writes the timeline to ``--out`` (default
``chiprun_out/actor_start_times.json``) and prints, after the smoke's own
output, one JSON line: the smoke's exit code and, for each phase, the
number of actor creations and the seconds of the slowest and of its worker
wait. Exits with the smoke's code.
"""

import argparse
import functools
import json
import os
import sys
import threading
import time
import traceback

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        HERE, "chiprun_out", "actor_start_times.json"))
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke
    from ray_tpu_torch.raylet.raylet import Raylet

    t0 = time.monotonic()
    phase = ["(before the first phase line)"]
    starts, samples = [], []
    open_starts = {}

    def now():
        return round(time.monotonic() - t0, 3)

    smoke_log = chip_smoke.log

    def log(*a):
        line = " ".join(map(str, a))
        if line.startswith("["):
            phase[0] = line[:80]
        smoke_log(*a)
    chip_smoke.log = log

    pop_worker = Raylet._pop_worker

    @functools.wraps(pop_worker)
    async def timed_pop(self, *a, **k):
        t = time.monotonic()
        try:
            return await pop_worker(self, *a, **k)
        finally:
            rec = open_starts.get(id(asyncio_current()))
            if rec is not None:
                rec["pop_s"] = time.monotonic() - t
    Raylet._pop_worker = timed_pop

    start_actor = Raylet.h_start_actor

    @functools.wraps(start_actor)
    async def timed_start(self, *a, **k):
        rec = {"t": now(), "phase": phase[0], "pop_s": None}
        key = id(asyncio_current())
        open_starts[key] = rec
        t = time.monotonic()
        try:
            reply = await start_actor(self, *a, **k)
            rec["ok"] = bool(reply.get("ok"))
            rec["reason"] = reply.get("reason")
            return reply
        except BaseException as e:
            rec["ok"], rec["reason"] = False, repr(e)
            raise
        finally:
            rec["s"] = time.monotonic() - t
            open_starts.pop(key, None)
            starts.append(rec)
    Raylet.h_start_actor = timed_start

    def sampler():
        while True:
            time.sleep(2.0)
            late = [time.monotonic() - t0 - r["t"]
                    for r in list(open_starts.values())]
            late = [s for s in late if s > 6.0]
            if not late or len(samples) >= 100:
                continue
            names = {t.ident: t.name for t in threading.enumerate()}
            stacks = {}
            for tid, fr in sys._current_frames().items():
                st = []
                while fr is not None and len(st) < 6:
                    st.append(f"{os.path.basename(fr.f_code.co_filename)}:"
                              f"{fr.f_lineno}:{fr.f_code.co_name}")
                    fr = fr.f_back
                stacks[names.get(tid, str(tid))] = st
            samples.append({"t": now(), "open_s": max(late),
                            "phase": phase[0], "threads": stacks})
    threading.Thread(target=sampler, daemon=True,
                     name="actor-start-sampler").start()

    try:
        rc = chip_smoke.main()
    except BaseException:  # noqa: BLE001 — report the timeline anyway
        traceback.print_exc()
        rc = 1
    by_phase = {}
    for r in starts:
        p = by_phase.setdefault(r["phase"][:40], {
            "creations": 0, "max_s": 0.0, "max_pop_s": 0.0})
        p["creations"] += 1
        p["max_s"] = max(p["max_s"], r["s"])
        p["max_pop_s"] = max(p["max_pop_s"], r["pop_s"] or 0.0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"rc": rc, "starts": starts, "samples": samples,
                   "by_phase": by_phase}, f, indent=1)
    print(json.dumps({"rc": rc, "by_phase": by_phase}), flush=True)
    return rc


def asyncio_current():
    import asyncio

    return asyncio.current_task()


if __name__ == "__main__":
    sys.exit(main())
