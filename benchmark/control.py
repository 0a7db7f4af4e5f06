"""The control of ``correct``: for each seed, a short run of the cell at its
own load whose served requests are judged twice, against the reference at
the configuration's width (the program's reading) and with the reference
one step lower (int4 for the int8 configurations) put in the program's
place (the control's reading). Both go through ``run.py``'s comparison with
the cell's limit: the program has to come out correct, the control not.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 8

Prints one JSON line per seed and a summary line; exits 1 if the control
came out correct on any seed. Runs on a CUDA card (``--device cpu`` runs it
on the CPU, which only the tests do).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import core  # noqa: E402
from benchmark import run as runner  # noqa: E402

CONTROL_BITS = {8: 4, 4: 2}  # the nearest width below the configuration's


def control(workload: str, seeds: list[int], seconds: float, device="cuda", cell=None,
            log=print) -> list[dict]:
    spec = core.load_spec()
    entry, config, mix = cell or core.cell(spec, workload)
    bits = CONTROL_BITS[config["quant"]["bits"]]
    out = []
    for seed in seeds:
        readings: list[dict] = []
        res = runner.run_cell(workload, seed, seconds, False, device=device, spec=spec,
                              cell=(entry, config, mix), log=lambda *a, **k: None,
                              control_bits=bits, readings_out=readings)
        ctl = res["control"]
        line = {"seed": seed, "attempted": res["attempted"],
                "limit": res["checks"]["widest_gap"]["limit"],
                "correct": res["correct"], "program": res["checks"]["widest_gap"]["value"],
                "control_correct": ctl["correct"], "control": ctl["checks"]["widest_gap"]["value"],
                "control_min": min(r["control_gap"] for r in readings),
                "tokens": sum(r["tokens"] for r in readings)}
        log(json.dumps(line), flush=True)
        out.append(line)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    lines = control(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds,
                    args.device)
    print(json.dumps({"workload": args.workload, "limit": lines[0]["limit"],
                      "program_correct": all(x["correct"] for x in lines),
                      "program_max": max(x["program"] for x in lines),
                      "control_correct": any(x["control_correct"] for x in lines),
                      "control_min": min(x["control"] for x in lines)}))
    return 1 if any(x["control_correct"] for x in lines) else 0


if __name__ == "__main__":
    sys.exit(main())
