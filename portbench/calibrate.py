"""The readings that the limits of the check are set from, in one process.

    python3 -m portbench.calibrate --workload base.batch --seeds 11,12,13 --seconds 5
    python3 -m portbench.calibrate --workload conformer.batch --seeds 21,22,23 \\
        --control reference-fp8

Without `--control` each seed is a whole run of the cell (set-up, a window
of `--seconds`, the check) and its numbers are the lower readings.
`reference-fp8`, the control, puts the reference in the program's place at
a lower precision than the configuration's bf16 — its matrix products'
operands rounded to float8 e4m3 — (its path, evidence and words for each
judged item) and needs no window. `reference-dp-late` reads a fault
instead: the f32 reference with its DP one frame late (its path the best
of the emissions delayed by a frame). One JSON line a
seed, then the smallest and the largest reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def reference_control(workload: str, seed: int, device: str = "cuda",
                      fault: str = "fp8") -> dict:
    """The numbers of the reference put in the program's place: at fp8
    (`fault="fp8"`), or at f32 with its DP one frame late (`"dp-late"`: the
    best path of the emissions delayed by a frame, a fault of the DP)."""
    import torch

    from . import check, drivers, generate, run, weights
    from .reference import grouping, viterbi
    from .reference.text import tokenize

    ctx = run.Context(workload, seed, device)
    ctx.params = weights.make(ctx.cfg, seed, ctx.device)
    driver = drivers.load(ctx.mix["entry"])(ctx)
    driver.pool = generate.items(ctx.mix, seed, ctx.device)
    judged = driver.sample({driver.key(it) for it in driver.pool})
    stride_ms = 1000.0 * float(np.prod(ctx.cfg["conv_stride"])) / 16000.0
    captured = {}
    for key, item in judged.items():
        seq = tokenize(item.transcript, ctx.vocab, ctx.blank_id, ctx.word_sep_id)
        lp = check.reference_log_probs(ctx, item, quant="fp8" if fault == "fp8" else None)
        if fault == "dp-late":
            path = viterbi.best_path(torch.cat([lp[:1], lp[:-1]]), seq.tokens)
        else:
            path = viterbi.best_path(lp, seq.tokens)
        ev = grouping.frame_evidence_from_log_probs(lp.cpu().numpy(), seq.tokens, path,
                                                    ctx.blank_id)
        words = grouping.group_into_words(path, seq.tokens, seq.chars, seq.normalized_words,
                                          ev, ctx.blank_id, ctx.word_sep_id, stride_ms)
        captured[key] = dict(path=path, log_probs=lp, emit_lp=ev.emit_lp, margin=ev.margin,
                             blank_prob=ev.blank_prob, entropy=ev.entropy,
                             tokens=list(seq.tokens), chars=list(seq.chars),
                             words=[(w.word, w.start_ms, w.end_ms, w.confidence)
                                    for w in words])
    words = {k: [c["words"]] for k, c in captured.items()}
    return check.judge(ctx, judged, captured, words, words)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", choices=("reference-fp8", "reference-dp-late"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from . import run

    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.control:
            numbers = reference_control(args.workload, seed, args.device,
                                        args.control.split("-", 1)[1])
        else:
            result, extras = run.run(args.workload, seed, args.seconds, False,
                                     device=args.device)
            numbers = {k: v["value"] for k, v in result["checks"].items()}
            print(json.dumps({"seed": seed, "check_s": extras["check_s"],
                              "window": extras["stats"]}), flush=True)
        rows.append(numbers)
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          **numbers}), flush=True)
    summary = {k: [min(r[k] for r in rows), max(r[k] for r in rows)] for k in rows[0]}
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "min_max": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
