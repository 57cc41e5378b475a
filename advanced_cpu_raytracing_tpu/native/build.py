"""Build the native runtime library (libacrt.so) with g++.

Invoked lazily by bindings.py on first use (and by `python -m
advanced_cpu_raytracing_tpu.native.build` explicitly).  The library goes to
``_build/`` beside the sources, which git ignores: it is always built on the
host that loads it, for the generic x86-64 target, never committed.  Pure C
ABI — no pybind11 needed; Python talks to it via ctypes.
"""

from __future__ import annotations

import os
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))
LIB = os.path.join(HERE, "_build", "libacrt.so")
SOURCES = ["bvh_builder.cpp", "ply_reader.cpp"]


def build(force: bool = False) -> str | None:
    srcs = [os.path.join(HERE, s) for s in SOURCES]
    if not force and os.path.exists(LIB):
        if all(os.path.getmtime(LIB) >= os.path.getmtime(s) for s in srcs):
            return LIB
    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", LIB, *srcs]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        # no toolchain or compile failure: python fallbacks take over
        return None
    return LIB


if __name__ == "__main__":
    path = build(force=True)
    print(path or "build failed")
