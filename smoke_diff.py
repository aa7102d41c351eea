#!/usr/bin/env python3
"""Compare the losses, grad norms and byte counts of two ``chip_smoke.py``
runs (e.g. the parent's and this tree's), field by field.

  python3 smoke_diff.py FIRST.log SECOND.log

Reads each log's phase lines (the JSON objects ``chip_smoke.emit``
prints), skipping the kernel, int8 kernel, profile and device phases,
whose numbers are times. A field is every number whose key path names a
loss, a norm or bytes (grad norms, bytes per (op, axis), cache and
memory bytes), keyed by its phase, the phase line's place among that
phase's lines and its path. Prints one JSON line: how many fields both
runs have, how many are equal, how many only one has, and the first 40
that differ with both values.
"""
from __future__ import annotations

import json
import re
import sys

KEY = re.compile(r"loss|norm|bytes")
TIMED_PHASES = ("kernels", "int8_ptxas", "int8_local_pass", "profile",
                "device")


def leaves(obj, path=()):
    """(key path, number) of every number under a key path that KEY
    matches."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from leaves(v, path + (str(k),))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from leaves(v, path + (str(i),))
    elif (isinstance(obj, (int, float)) and not isinstance(obj, bool)
          and any(KEY.search(p) for p in path)):
        yield "/".join(path), obj


def fields(log: str) -> dict:
    out, count = {}, {}
    with open(log) as f:
        for line in f:
            if not line.startswith('{"phase"'):
                continue
            rec = json.loads(line)
            phase = rec["phase"]
            if phase in TIMED_PHASES:
                continue
            i = count[phase] = count.get(phase, -1) + 1
            for k, v in leaves(rec):
                out[f"{phase}#{i}:{k}"] = v
    return out


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = fields(sys.argv[1]), fields(sys.argv[2])
    common = sorted(set(a) & set(b))
    differ = [k for k in common if a[k] != b[k]]
    print(json.dumps({"compared": len(common),
                      "equal": len(common) - len(differ),
                      "only_first": len(set(a) - set(b)),
                      "only_second": len(set(b) - set(a)),
                      "differ": {k: [a[k], b[k]] for k in differ[:40]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
