"""Phase 16 (c) of ``chip_smoke.py`` alone on the card, repeated, beside
CPU-spinning processes that stand in for a slower or busier host.

(c) serves RGAT and RGCN as two tenants of one process while RGCN's keys
grow and are captured during traffic; its check wants every request
``OK`` within a 1000 ms SLO. This script builds the kernels, optionally
runs phase 16 (a) and (b) first (``--warm``, as ``chip_smoke.py`` does),
then, for each count of spinning processes, runs (c) ``--runs`` times at
each offered rate: ``rule`` is the script's (the smaller of
``TENANT_RATE`` and ``TENANT_SHARE`` of the rate one interpreter sustains
at one build a request, from RGAT's calibration probes),
a number is a fixed rate in req/s whatever the host. One JSON line a run;
the exit code is 0 when every run ended, passed or not.

    python3 tenant_probe.py --burners 0,12 --rates rule,100 --runs 2 --warm
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--burners", default="0",
                    help="comma-separated counts of CPU-spinning processes")
    ap.add_argument("--rates", default="rule",
                    help="comma-separated offered rates: rule or req/s")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--warm", action="store_true",
                    help="run phase 16 (a) and (b) first")
    ap.add_argument("--out", default=None, help="also write the runs here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("tenant_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as CS
    import hector_torch
    from repro_torch.kernels import build
    from repro_torch.launch import serve_rgnn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    build.build_all()
    if args.warm:
        for tag, kw in CS.ONLINE_RUNS[:2]:
            with CS.settled_heap(tag, card):
                CS.online_run(torch, serve_rgnn, tag, kw, card)
    rule = CS.OnlineRecorder.offered_rate
    runs = []
    for nburn in (int(x) for x in args.burners.split(",")):
        procs = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
                 for _ in range(nburn)]
        try:
            time.sleep(1.0)
            for _ in range(args.runs):
                for rate in args.rates.split(","):
                    CS.OnlineRecorder.offered_rate = (
                        rule if rate == "rule"
                        else lambda self, *a, r=float(rate), **k: r)
                    rec = dict(card=card, burners=nburn, rate=rate)
                    try:
                        with CS.settled_heap(f"c x{nburn} {rate}", card):
                            out = CS.online_tenants(torch, hector_torch,
                                                    card)
                        rec.update(ok=True, offered_rps=out["offered_rps"],
                                   probe_build_ms=out["probe_build_ms"],
                                   **{f"{m}_p{q}_ms": out[m][f"latency_ms_p{q}"]
                                      for m in ("rgat", "rgcn")
                                      for q in (50, 99)},
                                   rgcn_captures=out["rgcn"][
                                       "captures_after_warmup"],
                                   thread_cpu_share=out["thread_cpu_share"])
                    except CS.Failed as e:
                        rec.update(ok=False, failed=str(e))
                    print(json.dumps(rec), flush=True)
                    runs.append(rec)
        finally:
            CS.OnlineRecorder.offered_rate = rule
            for p in procs:
                p.kill()
                p.wait()
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
