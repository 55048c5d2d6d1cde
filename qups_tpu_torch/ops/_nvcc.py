"""Build and load the port's CUDA C++ kernels and its host C++ code.

Each source under ``qups_tpu_torch/csrc/`` has a plain ``extern "C"`` entry
point. :func:`load` compiles a kernel source (``.cu``) with ``nvcc`` for
``sm_90a`` on first use, into ``qups_tpu_torch/_build/`` (keyed by a hash of
the source, the shared headers ``csrc/*.cuh``, the sources it includes
(``INCLUDES``) and its :func:`flags`, so an edited source or header is
rebuilt), and loads it with ``ctypes``. :func:`load_host` does the same
for a host source (``.cpp``: the eikonal solver) with the host C++
compiler. A failed build raises with the compiler's output; nothing falls
back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# No fast math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
# The sources built with -fmad=false: nvcc would contract a*b+c into an FMA,
# eager PyTorch never does, and these kernels must round their delays and
# phases as the plain versions do (greens_finish: sum the taps to the plain
# version's bits). das.cu writes its delay path with the round-to-nearest
# intrinsics instead (nvcc never contracts them), so that the rest of its
# arithmetic may contract.
NO_FMAD = ("fdbf", "greens_freq", "greens_splat", "greens_finish")
# Sources that include another source of csrc/ (its bytes join the build key).
INCLUDES = {name + iq: ("das.cu",) for iq in ("", "_iq") for name in (
    "das_keep", "das_bf16", "das_i8", "das_keep_bf16", "das_keep_i8", "das_keep_acc16")}
INCLUDES.update({name + "_iq_wide": ("das.cu",) for name in (
    "das_keep", "das_keep_bf16", "das_keep_i8", "das_keep_acc16")})
INCLUDES["das_iq"] = ("das.cu",)


def flags(name: str) -> Tuple[str, ...]:
    """The nvcc flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + (("-fmad=false",) if name in NO_FMAD else ())


# The host sources' flags: the JAX package's native Makefile's
# (qups_tpu/native/Makefile), so that both packages build one solver alike.
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_loaded: Dict[str, Tuple[ctypes.CDLL, str]] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def load(name: str) -> Tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<name>.cu`` unless this source is built already, load
    it once per process, and return ``(library, nvcc log)``; the log is
    empty when the library was built by an earlier process."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    headers += b"".join((CSRC / f).read_bytes() for f in INCLUDES.get(name, ()))
    _loaded[name] = _build(src, headers, [nvcc(), *flags(name)])
    return _loaded[name]


def host_cxx() -> Optional[str]:
    """The host C++ compiler: ``$CXX``, else ``c++`` or ``g++`` on the
    PATH; None where there is none."""
    for cxx in (os.environ.get("CXX"), "c++", "g++"):
        if cxx and shutil.which(cxx):
            return shutil.which(cxx)
    return None


def load_host(name: str) -> Tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<name>.cpp`` with the host C++ compiler and
    ``CXX_FLAGS`` unless it is built already, load it once per process, and
    return ``(library, compiler log)``. Raises ``RuntimeError`` where there
    is no host compiler or the build fails."""
    if name in _loaded:
        return _loaded[name]
    cxx = host_cxx()
    if cxx is None:
        raise RuntimeError(f"building {name}.cpp needs a host C++ compiler ($CXX, c++ "
                           "or g++) and none is on the PATH")
    _loaded[name] = _build(CSRC / f"{name}.cpp", cxx.encode(), [cxx, *CXX_FLAGS])
    return _loaded[name]


def _build(src: Path, extra: bytes, cmd: list) -> Tuple[ctypes.CDLL, str]:
    """Build ``src`` with ``cmd + ["-o", out, src]`` into ``BUILD_DIR``,
    keyed by the source, ``extra`` bytes and the command's flags, unless
    it is there already; load it."""
    key = hashlib.sha256(src.read_bytes() + extra
                         + " ".join(cmd[1:]).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{src.stem}_{key}.so"
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [*cmd, "-o", str(tmp), str(src)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        log = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"building {src.name} failed ({' '.join(cmd)}):\n{log}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), log


def stream_args(dev) -> Tuple[int, int]:
    """(device index, cudaStream_t of the current stream) for a launch."""
    import torch

    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return idx, torch.cuda.current_stream(dev).cuda_stream
