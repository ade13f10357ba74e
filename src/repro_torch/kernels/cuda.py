"""Build, load and launch the port's CUDA kernels.

The sources under `csrc/` are compiled at first use with `nvcc` for
`sm_90a` into a shared library with a plain C interface, loaded through
`ctypes` (no PyTorch headers, so a build takes seconds). The library lands in
`build/kernels/` at the root of the checkout (or `$REPRO_TORCH_BUILD_DIR`),
named by a hash of the sources and flags, so an edited source rebuilds and a
stale library is never loaded. A missing `nvcc` or a failed build raises.

`launch_conv` is the one launch site: it checks device, dtype, contiguity and
shapes, allocates the output with `torch.empty`, launches on PyTorch's
current stream without synchronising, and raises on a nonzero
`cudaGetLastError()`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("ecr_conv.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_CHECKOUT = Path(__file__).resolve().parents[3]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build_dir() -> Path:
    """Where the library is built: $REPRO_TORCH_BUILD_DIR if set, else
    `build/kernels/` of the source checkout the package runs from. Raises
    when the package runs from elsewhere (an installed copy) and no build
    directory was named, rather than writing beside site-packages."""
    if os.environ.get("REPRO_TORCH_BUILD_DIR"):
        return Path(os.environ["REPRO_TORCH_BUILD_DIR"])
    if not ((_CHECKOUT / "pyproject.toml").is_file()
            and (_CHECKOUT / "src" / "repro_torch").is_dir()):
        raise RuntimeError("repro_torch does not run from a source checkout: "
                           "set REPRO_TORCH_BUILD_DIR to a writable directory "
                           "for the built CUDA kernels")
    return _CHECKOUT / "build" / "kernels"


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default location. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the repro_torch CUDA kernels are built at first use")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return build_dir() / f"libreprotorch_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if this exact source has not been built yet) and
    return the library's path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n"
                           f"{r.stdout}\n{r.stderr}")
    if verbose:
        print(r.stdout + r.stderr)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptrs = [ctypes.c_void_p] * 5
            ints = [ctypes.c_int] * 9
            lib.repro_ecr_conv_f32.argtypes = ptrs + ints + [ctypes.c_void_p]
            lib.repro_ecr_conv_f32.restype = ctypes.c_int
            lib.repro_conv_pool_f32.argtypes = ptrs + ints + [ctypes.c_int, ctypes.c_void_p]
            lib.repro_conv_pool_f32.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_conv_operands(x, w, ids, cnt, block_c: int, stride: int) -> tuple:
    """Validate the packed operands every conv kernel takes; returns
    (n, h, wd, c, o, kh, kw, oh, ow)."""
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"expected x (N,H,W,C) and w (kh,kw,C,O), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wd, c = x.shape
    kh, kw, c2, o = w.shape
    if c2 != c or block_c < 1 or c % block_c:
        raise ValueError(f"channels {c} (weights {c2}) must match and be a "
                         f"multiple of block_c={block_c}")
    n_cb = c // block_c
    if tuple(ids.shape) != (n, n_cb) or tuple(cnt.shape) != (n,):
        raise ValueError(f"schedule shapes ids {tuple(ids.shape)} / cnt "
                         f"{tuple(cnt.shape)} do not match (N={n}, n_cb={n_cb})")
    if stride < 1 or h < kh or wd < kw:
        raise ValueError(f"map ({h},{wd}) too small for a {kh}x{kw} kernel "
                         f"at stride {stride}")
    return n, h, wd, c, o, kh, kw, (h - kh) // stride + 1, (wd - kw) // stride + 1


def launch_conv(x, w, ids, cnt, *, stride: int, block_c: int, pool: int = 0):
    """Launch the ECR conv kernel (pool=0) or the PECR conv+ReLU+pool kernel
    (pool=p) on CUDA tensors: x (N,H,W,C) f32, w (kh,kw,C,O) f32,
    ids (N,n_cb) int32, cnt (N,) int32 -> (N,OH,OW,O) or (N,OH/p,OW/p,O)."""
    n, h, wd, c, o, kh, kw, oh, ow = check_conv_operands(x, w, ids, cnt,
                                                          block_c, stride)
    tensors = (x, w, ids, cnt)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("CUDA conv kernel needs every operand on one CUDA device")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"CUDA conv kernel takes float32, got {x.dtype}/{w.dtype}")
    if ids.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise TypeError(f"schedules must be int32, got {ids.dtype}/{cnt.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("CUDA conv kernel needs contiguous operands")
    if pool:
        if pool > 8 or oh // pool < 1 or ow // pool < 1:
            raise ValueError(f"pool {pool} unsupported on a ({oh},{ow}) conv map")
        out = torch.empty((n, oh // pool, ow // pool, o), device=dev, dtype=torch.float32)
    else:
        out = torch.empty((n, oh, ow, o), device=dev, dtype=torch.float32)
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (x.data_ptr(), w.data_ptr(), ids.data_ptr(), cnt.data_ptr(), out.data_ptr())
    dims = (n, h, wd, c, o, kh, kw, stride, block_c)
    with torch.cuda.device(dev):
        if pool:
            err = lib.repro_conv_pool_f32(*ptrs, *dims, pool, stream)
        else:
            err = lib.repro_ecr_conv_f32(*ptrs, *dims, stream)
    if err != 0:
        raise RuntimeError(f"CUDA conv kernel launch failed: cudaError {err} "
                           f"(x {tuple(x.shape)}, w {tuple(w.shape)}, "
                           f"stride {stride}, block_c {block_c}, pool {pool})")
    return out
