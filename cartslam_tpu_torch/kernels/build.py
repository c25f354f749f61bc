"""Build and load the CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into an
object, and the objects are linked into ONE shared library with a plain C
interface, loaded with ``ctypes``.  No PyTorch headers are involved, so a
cold build takes seconds.  The library lives under ``build/cartslam_tpu_torch/``
in the checkout and is named by a hash of the sources and flags: the first
use builds it, and a changed source builds a new one.

Each C entry point launches on the stream it is given (the wrapper passes
``torch.cuda.current_stream().cuda_stream``) and returns
``cudaGetLastError()``; ``check`` raises when that is not 0.  A wrapper
runs with the card of its tensors current (``on_its_card``), so that
stream is that card's.

The objects are compiled with ``-Xptxas -v``: ptxas's report of each
kernel's registers, shared memory and spill bytes is kept beside the
library (``<library>.ptxas.txt``) and parsed by ``kernel_resources``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cartslam_tpu_torch"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Per-file extra flags.  relax.cu must not contract a*b+c into FMAs: its
# plain version (separate PyTorch ops) rounds after every operation.
FILE_FLAGS = {"relax.cu": ["-fmad=false"]}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (all return cudaError_t as int).
SIGNATURES = {
    "sgm_paths": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "sgm_wta": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "sgm_aggregate": [_P] * 5 + [_I] * 6 + [_P],
    "sgm_sharded_rows": [_P] * 5 + [_I] * 6 + [_P],
    "sgm_sharded_cols": [_P] * 7 + [_I] * 6 + [_P],
    "sgm_vcarry": [_P] * 8 + [_I] * 6 + [_P],
    "moment_tally": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "label_tally": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "tally_to_float": [_P, _P, _I, _P],
    "vote_tally": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "relax_label_rows": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "relax_sweeps": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I,
                     _I, _P],
    "relax_instantiation": [_I, _I, _P, _P, _P, _P],
    "stamp": [_P, _I, _P],
    "median3x3": [_P, _P, _I, _I, _I, _I, _P],
    "census": [_P, _P, _P, _I, _I, _I, _P],
}


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when an existing library was loaded
    built: bool

    @property
    def report(self) -> Path:
        """ptxas's -v report of the library's kernels."""
        return self.path.with_suffix(".ptxas.txt")


_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source_files() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256()
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(repr((ARCH, COMMON_FLAGS, sorted(FILE_FLAGS.items()))).encode())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the library if no library of the current sources exists."""
    sources = source_files()
    lib_path = BUILD_DIR / f"libcartslam_kernels_{_digest(sources)}.so"
    if lib_path.exists():
        return BuildInfo(lib_path, 0.0, False)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = BUILD_DIR / f"tmp_{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    procs = []
    objs = []
    report = []
    for src in sources:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *ARCH, *COMMON_FLAGS, *FILE_FLAGS.get(src.name, []),
               "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        objs.append(str(obj))
    for cmd, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
        report.append(out)
    part = tmp / lib_path.name
    link = [nvcc, *ARCH, "-shared", "-o", str(part), *objs]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({' '.join(link)}):\n{res.stdout}")
    info = BuildInfo(lib_path, time.perf_counter() - t0, True)
    info.report.write_text("".join(report))
    os.replace(part, lib_path)
    shutil.rmtree(tmp, ignore_errors=True)
    return info


def _demangle(names: list[str]) -> list[str]:
    """Readable kernel names through the toolkit's cu++filt (or c++filt),
    where there is one."""
    nvcc = shutil.which("nvcc")
    beside = Path(nvcc).parent / "cu++filt" if nvcc else None
    tool = (str(beside) if beside and beside.exists() else None) or shutil.which("cu++filt") \
        or shutil.which("c++filt")
    if not names or tool is None:
        return names
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    out = res.stdout.splitlines()
    return out if res.returncode == 0 and len(out) == len(names) else names


def kernel_resources(report: str) -> list[dict]:
    """Per kernel of a ptxas -v report: name, registers, static shared
    memory bytes, stack frame and spill store / load bytes."""
    kernels, cur, props = [], None, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(name=m.group(1), registers=0, smem=0, stack=0, spill_stores=0,
                       spill_loads=0)
            kernels.append(cur)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and props == cur["name"]:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    for k, name in zip(kernels, _demangle([k["name"] for k in kernels])):
        k["name"] = _short_name(name)
    return kernels


def _short_name(name: str) -> str:
    """A demangled kernel name without its return type, namespace and
    parameter list: 'sgm_wta_kernel', 'relax_sweeps_kernel<(bool)1>'."""
    name = re.sub(r"^void ", "", name)
    name = re.sub(r"^(\(anonymous namespace\)|<unnamed>)::", "", name)
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i]
    return name


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's device pointer, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def on_its_card(fn):
    """A kernel wrapper run with the card of its first argument (a tensor)
    current, so that its launches go to that card and to the card's current
    stream, on which PyTorch orders the memory of the wrapper's outputs and
    scratch.  Called from another current card, a launch would go to that
    card's stream, unordered with the memory, which the allocator could hand
    out again while the kernel still uses it."""
    @functools.wraps(fn)
    def wrapper(first, *args, **kw):
        if first.device.type != "cuda" or first.device.index == torch.cuda.current_device():
            return fn(first, *args, **kw)
        with torch.cuda.device(first.device):
            return fn(first, *args, **kw)
    return wrapper


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple | None = None,
           device: torch.device | None = None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and shape)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


@dataclasses.dataclass
class Counter:
    """Launch count of one kernel wrapper, and how often its plain version
    ran in the wrapper's place (CPU tensors only)."""

    name: str
    launches: int = 0
    plain_calls: int = 0


COUNTERS: dict[str, Counter] = {}


def counter(name: str) -> Counter:
    return COUNTERS.setdefault(name, Counter(name))


def reset_counts() -> None:
    for c in COUNTERS.values():
        c.launches = 0
        c.plain_calls = 0
