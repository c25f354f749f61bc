"""Build the port's native host library (the region-growing core).

``build()`` compiles ``cluster.cpp`` with ``g++ -O3 -shared -fPIC`` into
``build/cartslam_tpu_torch/libcartnative_<hash>.so`` in the checkout (never
into the source tree), named by a hash of the source and flags, so a
changed source builds a new library.  The library is written under a
temporary name and renamed into place, so concurrent first uses do not
see a partial file.  ``python -m cartslam_tpu_torch.native.build`` builds
it ahead of use.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "cluster.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cartslam_tpu_torch"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + repr(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libcartnative_{h}.so"


def build() -> Path:
    """The library of the current source, compiled if it does not exist
    (raises if g++ fails or is missing)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    part = out.with_name(f"{out.name}.{os.getpid()}.part")
    cmd = ["g++", *FLAGS, "-o", str(part), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        part.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(part, out)
    return out


if __name__ == "__main__":
    print(f"built {build()}")
    sys.exit(0)
