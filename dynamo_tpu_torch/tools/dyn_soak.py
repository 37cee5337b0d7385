#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``dyn://`` cell N times on one card, keeping every log.

    python3 dynamo_tpu_torch/tools/dyn_soak.py [N]    # default 8

Builds the kernels, writes the 2-layer Llama-3-8B-width front-door
checkpoint, serves the front-door requests in-process once (the greedy
texts each round must answer), then runs ``dyn_phase`` N times: a
coordinator, ``run in=dyn://... out=gpu`` and the ``http`` frontend as
processes of their own, a warm-up pass and the measured pass.  Each
round's worker and frontend logs are copied to ``chiprun_out/dyn_soak/``,
and each round prints its log lines that warn or fail (a lease that lapsed
and was healed, a request that failed) and its verdict.  The last line
counts the failed rounds and the rounds whose worker lease lapsed.  Exits
1 if any round failed or lapsed.
"""

from __future__ import annotations

import pathlib
import shutil
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
MARKS = ("WARNING", "ERROR", "Traceback", "expired", "failed")


def main() -> int:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from dynamo_tpu_torch.ops.kernels import build

    out = ROOT / "chiprun_out" / "dyn_soak"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    build.build_library()
    build.library()
    card = cs.card_line()
    print(card, flush=True)
    shutil.rmtree(cs.FRONT_DIR, ignore_errors=True)
    cs.write_tokenizer(cs.FRONT_DIR)
    cs.write_checkpoint(torch, cs.FRONT_DIR)
    texts, ttfts = cs.front_server(
        torch, cs.FRONT_FLAGS, card, "bf16 default path", ["decode", "prefill"],
        ["decode_q8", "prefill_q8", "ragged", "ragged_q8", "matmul", "moe", "moe_q8"])
    # dyn_phase removes its logs once a round passes: keep them for the copy
    unlink = pathlib.Path.unlink
    pathlib.Path.unlink = lambda self, missing_ok=False: None
    failed = lapsed = 0
    try:
        for i in range(rounds):
            t0 = time.perf_counter()
            try:
                cs.dyn_phase(card, texts, ttfts)
                verdict = "ok"
            except cs.SmokeFailure as e:
                failed += 1
                verdict = f"FAILED {e}"
            for name in ("worker", "http"):
                path = cs.FRONT_DIR / f"{name}.log"
                if not path.exists():
                    continue
                shutil.copy(path, out / f"{i}_{name}.log")
                marked = [ln for ln in path.read_text().splitlines()
                          if any(m in ln for m in MARKS)]
                lapsed += name == "worker" and any("expired" in ln for ln in marked)
                print(i, name, marked[:20], flush=True)
            print(i, f"{time.perf_counter() - t0:.1f} s", verdict, flush=True)
    finally:
        pathlib.Path.unlink = unlink
        shutil.rmtree(cs.FRONT_DIR, ignore_errors=True)
    print(f"rounds {rounds}, failed {failed}, worker lease lapsed {lapsed} ({card})")
    return 1 if failed or lapsed else 0


if __name__ == "__main__":
    sys.exit(main())
