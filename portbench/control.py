#!/usr/bin/env python3
"""The control of a cell's comparison: the reference put in the program's
place, with the configuration's ``control`` fault (``check.
control_answers``), judged by the comparison that decides ``correct``.

    python3 portbench/control.py --workload NAME --seeds 11,12,13

It makes the cell's inputs, then for each seed draws the run's sample of
queries (as a run checks them, from every query of the list) and prints
one JSON line of the numbers compared and whether the control came out
not correct. It needs no card and runs no program; the benchmark's own
runs do not run it. The limits of ``portbench/configs/<name>.json`` are
set between the program's readings and these.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_readings(c: dict, seeds):
    """Yield, for each seed, the control's numbers compared and whether it
    came out not correct. The inputs are made once: the seed only draws
    the sample of queries, as in a run."""
    import shutil

    import numpy as np

    from portbench import check, gramindex, harness, textrules, traffic
    from portbench.reference import Reference
    conf, spec = c["config"], c["traffic"]
    tmp = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        texts, is_ja, status, _ = harness.make_corpus(conf, tmp)
        queries = traffic.Generator(spec, conf["table"], texts,
                                    is_ja).queries()
        corpus = gramindex.Corpus(textrules.normalize_all(texts))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    verify = conf["server"]["memory"]["verify_text"] != "off"
    for seed in seeds:
        t = time.monotonic()
        rng = np.random.default_rng(seed)
        sample = sorted(rng.choice(len(queries), min(harness.CHECKED,
                                                     len(queries)),
                                   replace=False).tolist())
        ref = Reference.for_queries(corpus, status, conf["table"], verify,
                                    [queries[i] for i in sample])
        got = check.control_answers(ref, queries, sample, conf["control"])
        compared = check.compare(ref, queries, got, 0, conf["limits"])
        yield {"workload": c["workload"]["name"], "seed": seed,
               "control": conf["control"], "compared": compared,
               "correct": all(v["value"] <= v["limit"]
                              for v in compared.values()),
               "seconds": time.monotonic() - t}


def main(argv) -> int:
    from portbench import harness
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    a = ap.parse_args(argv)
    c = harness.cell(a.workload)
    for out in control_readings(c, [int(s) for s in a.seeds.split(",")]):
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
