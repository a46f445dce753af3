"""The readings a cell's check limits are set from, in one process.

    python3 benchmark/calibrate.py --workload NAME --first-seed S \
        --seeds 12 --control-seeds 3 --seconds 3

For each of ``--seeds`` seeds (S, S + 1, ...) one run of the cell with a
window of ``--seconds`` at the cell's own sizes and load: the program's
check numbers (the lower readings).  Then for each of ``--control-seeds``
further seeds the cell's data and the requests a window would send, with
the control (the plain reference broken as ``benchmark/reference/``
describes) answering in the program's place: the control's numbers (the
upper readings).  One JSON line a run, then one with the largest program
reading and the smallest control reading of each number.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def calibrate(manifest, workload: str, first_seed: int, seeds: int,
              control_seeds: int, seconds: float, device,
              overrides: dict | None = None, show=print) -> dict:
    """@return {"program_max": {number: largest reading}, "control_min":
    {number: smallest reading}, "limits": the cell's limits}
    @param overrides as ``cell.run``'s (the tests' small sizes)"""
    import torch
    from benchlib import cell
    from benchlib.manifest import part
    from benchlib.traffic import WINDOW

    def free():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    program: dict = {}
    control: dict = {}
    seed = first_seed
    for _ in range(seeds):
        out = cell.run(manifest, workload, seed, seconds, False, device,
                       time.perf_counter(), overrides)
        nums = {k: v["value"] for k, v in out["checks"].items()}
        show(json.dumps(cell._clean({"seed": seed, "side": "program",
                                     "correct": out["correct"],
                                     "numbers": nums})))
        for k, v in nums.items():
            program[k] = max(program.get(k, v), v)
        seed += 1
        free()
    entry = manifest.cell(workload)
    cfg = manifest.config(entry["config"])
    mix = manifest.traffic(entry["traffic"])
    if overrides:
        cfg.update(overrides.get("config", {}))
        mix.update(overrides.get("traffic", {}))
    check = entry["check"]
    for _ in range(control_seeds):
        verb_mod = part("verbs", f"{cfg['index']}.{mix['verb']}")
        system = part("indexes", cfg["index"]).System(
            cfg, mix, seed, device,
            media_table=getattr(verb_mod, "MEDIA_TABLE", False))
        verb = verb_mod.Verb(system, mix, seed)
        kept = [(verb.requests.request(WINDOW, i), None)
                for i in range(check["requests"])]
        system.free()
        nums = verb.check(kept, check.get("sample", {}), seed, control=True)
        show(json.dumps(cell._clean({"seed": seed, "side": "control",
                                     "numbers": nums})))
        for k, v in nums.items():
            control[k] = min(control.get(k, v), v)
        del system, verb, kept
        seed += 1
        free()
    return {"workload": workload, "program_max": program,
            "control_min": control, "limits": check["limits"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch
    from benchlib import cell
    from benchlib.manifest import Manifest
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    out = calibrate(Manifest(ROOT), args.workload, args.first_seed,
                    args.seeds, args.control_seeds, args.seconds,
                    torch.device("cuda", 0),
                    show=lambda line: print(line, flush=True))
    print(json.dumps(cell._clean(out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
