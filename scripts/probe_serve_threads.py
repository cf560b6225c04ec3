#!/usr/bin/env python3
"""What a SynthesisServer's first touches cost on one CUDA card.

Builds chip_smoke.py's f32 TTSKing (shipped width, seeded weights), a
SynthesisServer(max_batch=16) prewarmed as chip_smoke.py's serving phase
prewarms it, and measures:

  * ``stream()`` on the 192-frame sentence: ms to the first chunk and in
    all, three times on the calling thread, then once on each of four fresh
    threads (an HTTP ``/stream`` runs on a fresh handler thread), then three
    times on one more thread;
  * chip_smoke.py's f32 burst (32 requests) four times: the first burst
    after ``prewarm`` against the next ones.

Prints one JSON line. ``--repo DIR`` runs the package and chip_smoke.py of
another checkout (a parent's ``git archive``), for an A/B in one call:

    python3 scripts/probe_serve_threads.py [--repo build/parent]
"""

import argparse
import json
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=REPO)
    args = ap.parse_args(argv)
    # the checkout in place of scripts/, whose profile.py would shadow the
    # standard library's profile module that torch imports
    sys.path[0] = os.path.abspath(args.repo)

    import torch

    if not torch.cuda.is_available():
        print("probe_serve_threads: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tts_king_torch.serve import SynthesisServer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.main_config()
    cfg.preprocess.lexicon_path = os.path.join(cs.E2E_DIR, "lexicon.dict")
    king = cs.main_path_kings(cfg)["f32"]
    server = SynthesisServer(king, max_batch=16)
    try:
        t0 = time.perf_counter()
        server.prewarm(max_phonemes=cs.SERVE_MAX_PHONEMES,
                       duration_controls=cs.SERVE_CONTROLS)
        prewarm_s = time.perf_counter() - t0
        requests = cs.serve_requests(king, 32, seed=5)
        bursts = [cs.serve_burst(server, requests)[2] for _ in range(4)]

        def stream_ms():
            t0, first = time.perf_counter(), None
            for _ in server.stream(text=cs.SENTENCES[1]):
                if first is None:
                    first = time.perf_counter() - t0
            return [first * 1e3, (time.perf_counter() - t0) * 1e3]

        def on_thread(n):
            out = []
            t = threading.Thread(
                target=lambda: out.extend(stream_ms() for _ in range(n)))
            t.start()
            t.join(timeout=300)
            return out

        res = {"repo": os.path.abspath(args.repo),
               "device": torch.cuda.get_device_name(0),
               "prewarm_s": prewarm_s, "burst_walls_s": bursts,
               "stream_ms_caller": [stream_ms() for _ in range(3)],
               "stream_ms_fresh_threads": [on_thread(1)[0] for _ in range(4)],
               "stream_ms_one_thread": on_thread(3)}
    finally:
        server.close()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
