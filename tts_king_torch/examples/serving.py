"""Serving walkthrough of the port (examples/serving.py's counterpart): the
HTTP front in-process, /tts (WAV) and /stream (chunked PCM) clients, a
deadline that sheds a request, /stats, and the drain and restart through a
state file that a replacement server adopts.

    python -m tts_king_torch.examples.serving [--micro] [--device cpu]

(The CLI equivalent: ``python -m tts_king_torch.serve --port 8765
--prewarm --state-file serving_state.json``, then SIGTERM it and start it
again.) The state file goes to a temporary directory.
"""

import argparse
import json
import os
import tempfile
import threading
import urllib.error
import urllib.request

import numpy as np


def post(base, path, body, timeout=300):
    req = urllib.request.Request(
        f"{base}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tts_king_torch.examples.serving")
    ap.add_argument("--micro", action="store_true",
                    help="toy model sizes (fast on the CPU; same flow)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tts_king_torch.examples.basic_usage import (bias_durations,
                                                     example_config,
                                                     example_king)
    from tts_king_torch.serve import SynthesisServer, serve_http

    king = example_king(example_config(args.micro), args.device)
    if args.micro:
        bias_durations(king)

    # --- the HTTP front (port 0 = ephemeral) ---------------------------
    httpd, server = serve_http(king, port=0, max_batch=8,
                               admission_depth=32)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    print("serving on", base)

    # --- one-shot WAV --------------------------------------------------
    phonemes = [70, 80, 90, 100, 110, 90, 80]
    r = post(base, "/tts", {"phonemes": phonemes, "speaker": 0})
    print(f"/tts -> {r.status}, {len(r.read())} bytes of WAV")

    # a request that cannot be served in time comes back 504 instead of
    # using the card
    try:
        post(base, "/tts", {"phonemes": phonemes, "deadline_ms": 0.001})
        print("/tts with 1us deadline -> served (machine faster than us)")
    except urllib.error.HTTPError as e:
        print(f"/tts with 1us deadline -> {e.code} (shed, no compute spent)")

    # --- low-latency streaming -----------------------------------------
    r = post(base, "/stream", {"phonemes": phonemes})
    pcm = np.frombuffer(r.read(), np.int16)
    print(f"/stream -> {r.status}, {pcm.shape[0]} samples (chunks arrive "
          "as vocoded; the first after one FS2 call and one vocoder "
          "window)")

    # --- stats and load-derived tuning ---------------------------------
    stats = json.loads(urllib.request.urlopen(base + "/stats").read())
    print("stats:", stats)
    print("suggested padding grids from recorded load:",
          server.suggest_buckets())

    # --- graceful drain and restart ------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        state_file = os.path.join(tmp, "serving_state.json")
        httpd.shutdown()                       # stop accepting HTTP
        httpd.server_close()
        server.drain(timeout=60)               # finish admitted work
        server.save_serving_state(state_file)  # tuning for the successor
        print("drained; serving state ->", state_file)
        state = SynthesisServer.load_serving_state(state_file)
    # the replacement adopts the tuned grids (prewarm=False keeps the
    # example short)
    server2 = SynthesisServer.from_serving_state(king, state, prewarm=False,
                                                 max_batch=8)
    wav = server2.submit(phonemes=phonemes).result(timeout=300)
    print(f"restarted server answered: {wav.shape[0]} samples")
    server2.close()
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
