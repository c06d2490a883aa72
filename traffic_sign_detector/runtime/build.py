"""Build the native loader: g++ -O2 -shared against libjpeg.

Usage: python -m traffic_sign_detector.runtime.build
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "loader.cpp")
OUT = os.path.join(HERE, "libtsd_loader.so")


def build(verbose: bool = True) -> str | None:
    cmd = [
        "g++", "-O2", "-fPIC", "-shared", "-std=c++17",
        SRC, "-o", OUT, "-ljpeg", "-lpthread",
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        if verbose:
            print(f"native loader build failed to launch: {e}", file=sys.stderr)
        return None
    if res.returncode != 0:
        if verbose:
            print(f"native loader build failed:\n{res.stderr}", file=sys.stderr)
        return None
    return OUT


if __name__ == "__main__":
    out = build()
    print(f"built {out}" if out else "build failed")
    sys.exit(0 if out else 1)
