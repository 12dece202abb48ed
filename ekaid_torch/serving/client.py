"""Terminal client for the inference server (the port's own copy of
`ekaid_tpu/serving/client.py`; standard library only).

Ask free-form questions about the current study pair, refresh to a new
random pair, inspect its ground truth:

    python -m ekaid_torch.serving.client --server http://127.0.0.1:4000
    python -m ekaid_torch.serving.client --question "what has changed"
"""

from __future__ import annotations

import argparse
import json
import urllib.request


def _call(base: str, path: str, payload=None):
    if payload is None:
        req = urllib.request.Request(base + path)
    else:
        req = urllib.request.Request(
            base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def main(argv=None):
    p = argparse.ArgumentParser(description="EKAID demo client")
    p.add_argument("--server", default="http://127.0.0.1:4000")
    p.add_argument("--question", default=None,
                   help="one-shot question (non-interactive)")
    a = p.parse_args(argv)

    health = _call(a.server, "/health")
    print(f"connected: {health}")
    if a.question:
        print(json.dumps(_call(a.server, "/question",
                               {"question": a.question}), indent=2))
        return
    print("commands: <question text> | refresh | sample | exit")
    while True:
        try:
            line = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line:
            continue
        if line in ("exit", "exit()"):
            break
        if line == "refresh":
            print(_call(a.server, "/refresh", {}))
        elif line == "sample":
            print(json.dumps(_call(a.server, "/sample"), indent=2))
        else:
            out = _call(a.server, "/question", {"question": line})
            print(f"answer ({out['latency_ms']} ms): {out['answer']}")


if __name__ == "__main__":
    main()
