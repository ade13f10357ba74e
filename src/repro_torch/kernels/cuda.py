"""Build, load and launch the port's CUDA kernels.

The sources under `csrc/` are compiled at first use with `nvcc` for
`sm_90a`, one `nvcc` per source, all started together, and linked into one
shared library with a plain C interface, loaded through `ctypes` (no PyTorch
headers, so a build takes seconds). The library lands in
`build/kernels/` at the root of the checkout (or `$REPRO_TORCH_BUILD_DIR`),
named by a hash of the sources and flags, so an edited source rebuilds and a
stale library is never loaded. A missing `nvcc` or a failed build raises.

`launch_conv` (the ECR / PECR conv kernels, fp32 on the split-TF32 tensor
cores, and the int8 tensor-core ECR conv), `launch_bsr` (the block-sparse
matmul, fp32 on the split-TF32 tensor cores, and its int8 tensor-core form),
`launch_flash` (the flash attention forward: fp32 on the split-TF32 tensor
cores, int8 K/V dequantized as it is staged into the same body, bf16 on the
bf16 tensor cores), `launch_flash_bwd` (its two backward passes, fp32 on
the split-TF32 tensor cores, bf16 on the bf16 ones), `launch_flash_mla`
(the MLA attention forward over one latent kv head, fp32 q over an fp32 or
a bf16 latent, on the TF32 tensor cores; P.V over a bf16 latent on the
bf16 ones), `launch_flash_mla_bwd` (its dq
and dkv backward passes, on the TF32 tensor cores), `launch_selective_scan`
(the Mamba selective scan, fp32 or bf16 activations, one thread per
channel) and `launch_selective_scan_bwd` (its backward) are the launch
sites: they check device, dtype, layout and shapes, allocate the outputs
(and scratch) with `torch.empty`, launch on PyTorch's current stream
without synchronising, and raise on a nonzero `cudaGetLastError()`. The
conv and BSR kernels and both backwards take contiguous operands; the
flash kernels and the scan's forward read theirs through element strides.

`count_launch` is how a CNN kernel's wrapper counts a launch: one more in
its `.launches`, and one more in the calling thread's open
`recording_launches` record, which is how a CUDA-graph runner learns which
kernels one replay of its graph launches. `FLASH_ENTRY_LAUNCHES` counts the
flash launches per C entry point, so that a report can tell the bf16
launches from the fp32 ones; `MLA_ENTRY_LAUNCHES` does the same for the MLA
kernels' entry points and `SCAN_ENTRY_LAUNCHES` for the selective scan's.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("ecr_conv.cu", "ecr_conv_int8.cu", "bsr_matmul.cu", "bsr_matmul_int8.cu",
           "flash_attention.cu", "flash_attention_bwd.cu", "flash_mla.cu",
           "flash_mla_bwd.cu", "selective_scan.cu")
HEADERS = ("smem_io.cuh", "int8_mma.cuh", "tf32_mma.cuh", "bf16_mma.cuh",
           "flash_bf16.cuh")  # included; hashed
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
_CHECKOUT = Path(__file__).resolve().parents[3]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_recording = threading.local()

# launches per flash entry point, counted where each is called
FLASH_ENTRY_LAUNCHES = dict.fromkeys((
    "repro_flash_fwd_f32", "repro_flash_fwd_bf16", "repro_flash_fwd_q8",
    "repro_flash_bwd_dq_f32", "repro_flash_bwd_dq_bf16", "repro_flash_bwd_dkv_f32",
    "repro_flash_bwd_dkv_bf16"), 0)
# launches per MLA entry point: the forward (fp32 q over an fp32 latent, or
# over a bf16 one) and its two backward passes (fp32, or over a bf16 latent)
MLA_FWD_ENTRIES = ("repro_flash_fwd_mla_f32", "repro_flash_fwd_mla_bf16kv")
MLA_BWD_ENTRIES = ("repro_flash_bwd_mla_dq_f32", "repro_flash_bwd_mla_dq_bf16",
                   "repro_flash_bwd_mla_dkv_f32", "repro_flash_bwd_mla_dkv_bf16")
MLA_ENTRY_LAUNCHES = dict.fromkeys(MLA_FWD_ENTRIES + MLA_BWD_ENTRIES, 0)
# launches per entry point of the Mamba selective scan: forward and backward,
# over fp32 or bf16 activations
SCAN_ENTRY_LAUNCHES = dict.fromkeys((
    "repro_selective_scan_f32", "repro_selective_scan_bf16",
    "repro_selective_scan_bwd_f32", "repro_selective_scan_bwd_bf16"), 0)


def count_launch(wrapper) -> None:
    """Count one launch of `wrapper`'s kernel: in `wrapper.launches`, and in
    the calling thread's open `recording_launches` record (other threads'
    launches never reach it)."""
    wrapper.launches += 1
    counts = getattr(_recording, "counts", None)
    if counts is not None:
        counts[wrapper.__name__] = counts.get(wrapper.__name__, 0) + 1


@contextlib.contextmanager
def recording_launches():
    """Yield a dict that counts, by wrapper name, the kernel launches this
    thread makes inside the block."""
    outer = getattr(_recording, "counts", None)
    _recording.counts = counts = {}
    try:
        yield counts
    finally:
        _recording.counts = outer


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
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return build_dir() / f"libreprotorch_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list, verbose: bool) -> None:
    """Run the commands side by side; raise with the first failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{out}\n{err}")
        elif verbose:
            print(out + err)
    if failed:
        raise RuntimeError("\n".join(failed))


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if this exact source has not been built yet), one
    nvcc per source in parallel, link them, and return the library's path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = nvcc_path()
    objs = [out.with_name(f"{out.stem}.{Path(s).stem}.{tag}.o") for s in SOURCES]
    ptxas = ["-Xptxas", "-v"] if verbose else []
    _run([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(o), str(CSRC / s)]
          for s, o in zip(SOURCES, objs)], verbose)
    tmp = out.with_suffix(f".{tag}")
    _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]],
         verbose=False)
    for o in objs:
        o.unlink()
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
            lib.repro_ecr_conv_f32.argtypes = ptrs + ints + [ctypes.c_void_p, ctypes.c_int]
            lib.repro_ecr_conv_f32.restype = ctypes.c_int
            lib.repro_conv_pool_f32.argtypes = ptrs + ints + [ctypes.c_int, ctypes.c_void_p,
                                                              ctypes.c_int]
            lib.repro_conv_pool_f32.restype = ctypes.c_int
            lib.repro_ecr_conv_i8.argtypes = [ctypes.c_void_p] * 7 + ints + [ctypes.c_void_p]
            lib.repro_ecr_conv_i8.restype = ctypes.c_int
            geom = ctypes.POINTER(ctypes.c_int)
            lib.repro_ecr_conv_f32_tile.argtypes = [ctypes.c_int] * 11 + [geom]
            lib.repro_ecr_conv_f32_tile.restype = ctypes.c_int
            lib.repro_ecr_conv_i8_tile.argtypes = [ctypes.c_int] * 9 + [geom]
            lib.repro_ecr_conv_i8_tile.restype = ctypes.c_int
            bsr_ints = [ctypes.c_int] * 6
            lib.repro_bsr_matmul_f32.argtypes = ptrs + bsr_ints + [ctypes.c_void_p]
            lib.repro_bsr_matmul_f32.restype = ctypes.c_int
            lib.repro_bsr_matmul_i8.argtypes = [ctypes.c_void_p] * 7 + bsr_ints + [ctypes.c_void_p]
            lib.repro_bsr_matmul_i8.restype = ctypes.c_int
            dims = ctypes.POINTER(ctypes.c_int)
            strides = ctypes.POINTER(ctypes.c_longlong)
            for name, n_ptrs in (("repro_flash_fwd_f32", 6), ("repro_flash_fwd_bf16", 6),
                                 ("repro_flash_fwd_q8", 6), ("repro_flash_bwd_dq_f32", 8),
                                 ("repro_flash_bwd_dq_bf16", 8),
                                 ("repro_flash_bwd_dkv_f32", 9),
                                 ("repro_flash_bwd_dkv_bf16", 9)):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * n_ptrs + [dims, strides, ctypes.c_float,
                                                            ctypes.c_void_p]
                fn.restype = ctypes.c_int
            for name in MLA_FWD_ENTRIES:
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * 7 + [dims, strides, ctypes.c_float,
                                                       ctypes.c_void_p]
                fn.restype = ctypes.c_int
            for name in MLA_BWD_ENTRIES:
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_void_p] * 8 + [dims, ctypes.c_float, ctypes.c_float,
                                                        ctypes.c_void_p]
                               if "_dq_" in name else
                               [ctypes.c_void_p] * 10 + [dims, ctypes.c_float, ctypes.c_void_p])
                fn.restype = ctypes.c_int
            for name in SCAN_ENTRY_LAUNCHES:
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_void_p] * 22 + [dims, ctypes.c_void_p]
                               if "_bwd_" in name else
                               [ctypes.c_void_p] * 10 + [dims, strides, ctypes.c_void_p])
                fn.restype = ctypes.c_int
            geometry = (ctypes.c_int * 2)()
            lib.repro_selective_scan_bwd_geometry(geometry)
            check_scan_geometry(tuple(geometry))
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


def _check_device(tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("CUDA kernel needs every operand on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("CUDA kernel needs contiguous operands")
    return dev


def check_scales(sa, sb, want_a: int, want_b: int, what: str) -> None:
    if sa is None or sb is None:
        raise ValueError(f"int8 {what} kernel needs both scales")
    if sa.dtype != torch.float32 or sb.dtype != torch.float32:
        raise TypeError(f"int8 {what} scales must be float32, got "
                        f"{sa.dtype}/{sb.dtype}")
    if sa.numel() != want_a or sb.numel() != want_b:
        raise ValueError(f"int8 {what} scales hold {sa.numel()}/{sb.numel()} "
                         f"values, want {want_a}/{want_b}")


def check_block_o(block_o: int) -> None:
    """The fp32 conv kernel's output tiles: 64 or 128 columns, or 0 for the
    launch's own choice."""
    if block_o not in (0, 64, 128):
        raise ValueError(f"the CUDA conv kernel takes block_o 0, 64 or 128, got {block_o}")


def conv_tile(n: int, h: int, w: int, c: int, o: int, kh: int, kw: int, *,
              stride: int, block_c: int, pool: int = 0, block_o: int = 0,
              int8: bool = False) -> tuple:
    """The tile the conv kernel's host code picks for this call, without
    launching: (TM, TN, tile rows, tile columns, spatial tiles, output-channel
    tiles, dynamic shared memory in bytes), on the current device. The
    Python mirror is `kernels.tiles.f32_conv_tile` / `i8_conv_tile`. Raises
    for a shape the kernel refuses."""
    out = (ctypes.c_int * 7)()
    lib = library()
    if int8:
        err = lib.repro_ecr_conv_i8_tile(n, h, w, c, o, kh, kw, stride, block_c, out)
    else:
        err = lib.repro_ecr_conv_f32_tile(n, h, w, c, o, kh, kw, stride, block_c, pool,
                                          block_o, out)
    if err != 0:
        raise RuntimeError(f"conv kernel refuses the shape (error {err})")
    return tuple(out)


def launch_conv(x, w, ids, cnt, *, stride: int, block_c: int, pool: int = 0,
                sx=None, sw=None, block_o: int = 0):
    """Launch the ECR conv kernel (pool=0) or the PECR conv+ReLU+pool kernel
    (pool=p) on CUDA tensors: x (N,H,W,C), w (kh,kw,C,O), ids (N,n_cb) int32,
    cnt (N,) int32 -> fp32 (N,OH,OW,O) or (N,OH/p,OW/p,O). x and w are both
    float32, or both int8 with per-sample scales sx (N values) and
    per-output-channel scales sw (O values), float32 (the int8 form has no
    pooled epilogue). block_o = 64 or 128 pins the fp32 kernel's
    output-channel tile; 0 keeps its own choice; the int8 kernel has a
    fixed tile and takes 0 only."""
    n, h, wd, c, o, kh, kw, oh, ow = check_conv_operands(x, w, ids, cnt,
                                                          block_c, stride)
    check_block_o(block_o)
    int8 = x.dtype == torch.int8
    if int8 and block_o:
        raise ValueError("the int8 conv kernel has a fixed output tile: block_o must be 0")
    tensors = (x, w, ids, cnt) + ((sx, sw) if int8 else ())
    if int8:
        check_scales(sx, sw, n, o, "conv")
    dev = _check_device(tensors)
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"CUDA conv kernel takes float32 or int8 operands of "
                        f"one type, got {x.dtype}/{w.dtype}")
    if ids.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise TypeError(f"schedules must be int32, got {ids.dtype}/{cnt.dtype}")
    if pool:
        if int8:
            raise ValueError("the int8 conv kernel has no pooled epilogue")
        if pool > 8 or oh // pool < 1 or ow // pool < 1:
            raise ValueError(f"pool {pool} unsupported on a ({oh},{ow}) conv map")
        out = torch.empty((n, oh // pool, ow // pool, o), device=dev, dtype=torch.float32)
    else:
        out = torch.empty((n, oh, ow, o), device=dev, dtype=torch.float32)
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    dims = (n, h, wd, c, o, kh, kw, stride, block_c)
    with torch.cuda.device(dev):
        if int8:
            err = lib.repro_ecr_conv_i8(x.data_ptr(), w.data_ptr(), ids.data_ptr(),
                                        cnt.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                                        out.data_ptr(), *dims, stream)
        else:
            ptrs = (x.data_ptr(), w.data_ptr(), ids.data_ptr(), cnt.data_ptr(),
                    out.data_ptr())
            if pool:
                err = lib.repro_conv_pool_f32(*ptrs, *dims, pool, stream, block_o)
            else:
                err = lib.repro_ecr_conv_f32(*ptrs, *dims, stream, block_o)
    if err != 0:
        raise RuntimeError(f"CUDA conv kernel launch failed: cudaError {err} "
                           f"(x {tuple(x.shape)} {x.dtype}, w {tuple(w.shape)}, "
                           f"stride {stride}, block_c {block_c}, pool {pool}, "
                           f"block_o {block_o})")
    return out


def check_bsr_operands(h, w, ids, cnt, block: tuple) -> tuple:
    """Validate the operands of the block-sparse matmul; returns
    (t, f, d, bt, bf, nt, nf). h (T,F) and w (F,D) need no padding: the
    schedule counts ceil(T/bt) row-blocks of ceil(F/bf) reduction blocks."""
    if h.ndim != 2 or w.ndim != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(f"expected h (T,F) and w (F,D), got {tuple(h.shape)} "
                         f"and {tuple(w.shape)}")
    t, f = h.shape
    d = w.shape[1]
    bt, bf = block
    if bt < 1 or bf < 1 or min(t, f, d) < 1:
        raise ValueError(f"bad block {block} for h {tuple(h.shape)}, w {tuple(w.shape)}")
    nt, nf = -(-t // bt), -(-f // bf)
    if tuple(ids.shape) != (nt, nf) or tuple(cnt.shape) != (nt,):
        raise ValueError(f"schedule shapes ids {tuple(ids.shape)} / cnt "
                         f"{tuple(cnt.shape)} do not match (nt={nt}, nf={nf})")
    return t, f, d, bt, bf, nt, nf


def launch_bsr(h, w, ids, cnt, *, block: tuple, sh=None, sw=None):
    """Launch the block-sparse matmul kernel on CUDA tensors: h (T,F),
    w (F,D), ids (ceil(T/bt), ceil(F/bf)) int32, cnt (ceil(T/bt),) int32 ->
    fp32 (T,D), scheduled in block = (bt, bf) blocks of h. Both float32, or
    both int8 with per-row scales sh (T values) and one scale sw, float32.
    The kernel takes bt = 8 row-blocks."""
    t, f, d, bt, bf, _, nf = check_bsr_operands(h, w, ids, cnt, block)
    if bt != 8:
        raise ValueError(f"the CUDA BSR kernel takes 8-row blocks, got bt={bt}")
    int8 = h.dtype == torch.int8
    tensors = (h, w, ids, cnt) + ((sh, sw) if int8 else ())
    if int8:
        check_scales(sh, sw, t, 1, "BSR")
    dev = _check_device(tensors)
    if h.dtype != w.dtype or h.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"CUDA BSR kernel takes float32 or int8 operands of "
                        f"one type, got {h.dtype}/{w.dtype}")
    if ids.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise TypeError(f"schedules must be int32, got {ids.dtype}/{cnt.dtype}")
    out = torch.empty((t, d), device=dev, dtype=torch.float32)
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    dims = (t, f, d, bt, bf, nf)
    with torch.cuda.device(dev):
        if int8:
            err = lib.repro_bsr_matmul_i8(h.data_ptr(), w.data_ptr(), ids.data_ptr(),
                                          cnt.data_ptr(), sh.data_ptr(), sw.data_ptr(),
                                          out.data_ptr(), *dims, stream)
        else:
            err = lib.repro_bsr_matmul_f32(h.data_ptr(), w.data_ptr(), ids.data_ptr(),
                                           cnt.data_ptr(), out.data_ptr(), *dims, stream)
    if err != 0:
        raise RuntimeError(f"CUDA BSR kernel launch failed: cudaError {err} "
                           f"(h {tuple(h.shape)} {h.dtype}, w {tuple(w.shape)}, "
                           f"block {tuple(block)})")
    return out


# the head dims each flash entry point is instantiated at: the fp32 and int8
# K/V forwards add stablelm-12b's 160; the bf16 forward and the backward
# passes do not take it yet (ROADMAP queue 2 item [10], interface parity)
FLASH_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
FLASH_FWD_HEAD_DIMS = (8, 16, 32, 64, 128, 160, 256)
FLASH_ENTRY_HEAD_DIMS = {
    "repro_flash_fwd_f32": FLASH_FWD_HEAD_DIMS,
    "repro_flash_fwd_q8": FLASH_FWD_HEAD_DIMS,
    "repro_flash_fwd_bf16": FLASH_HEAD_DIMS,
    "repro_flash_bwd_dq_f32": FLASH_HEAD_DIMS,
    "repro_flash_bwd_dkv_f32": FLASH_HEAD_DIMS,
    "repro_flash_bwd_dq_bf16": FLASH_HEAD_DIMS,
    "repro_flash_bwd_dkv_bf16": FLASH_HEAD_DIMS,
}
# the most query groups per kv head the flash kernels take: their tiles
# flatten (position, group) rows, and the tests cover G up to 64
FLASH_MAX_GROUPS = 64


def check_flash_operands(q, k, v, k_scale=None, v_scale=None) -> tuple:
    """Validate the flash-attention operands in either layout and return
    (nbkv, nh, g, sq, sk, d): the kernel's (BKV, G, Sq, D) queries over
    (BKV, Sk, D) keys (nh = 1), or the model's (B, Sq, KV, G, D) queries over
    the cache's (B, Sk, KV, D) keys (nh = KV, bkv = b * KV + h). Scales, for
    int8 K/V, are (BKV, Sk) or (B, Sk, KV)."""
    if q.ndim == 4 and k.ndim == 3:
        nbkv, g, sq, d = q.shape
        nh, sk = 1, k.shape[1]
        kv_shape, s_shape = (nbkv, sk, d), (nbkv, sk)
    elif q.ndim == 5 and k.ndim == 4:
        b, sq, nh, g, d = q.shape
        nbkv, sk = b * nh, k.shape[1]
        kv_shape, s_shape = (b, sk, nh, d), (b, sk, nh)
    else:
        raise ValueError(f"expected q (BKV,G,Sq,D) with k, v (BKV,Sk,D), or q "
                         f"(B,Sq,KV,G,D) with k, v (B,Sk,KV,D); got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if tuple(k.shape) != kv_shape or tuple(v.shape) != kv_shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)} (want {kv_shape})")
    if min(nbkv, g, sq, sk, d) < 1:
        raise ValueError(f"empty attention operands: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 K/V need both scales")
    if k_scale is not None and (tuple(k_scale.shape) != s_shape
                                or tuple(v_scale.shape) != s_shape):
        raise ValueError(f"scales {tuple(k_scale.shape)} / {tuple(v_scale.shape)} "
                         f"do not match the keys (want {s_shape})")
    return nbkv, nh, g, sq, sk, d


def _row_strides(t, kernel_layout: bool) -> tuple:
    """(b, h, g, s) element strides of a query-shaped tensor."""
    if kernel_layout:
        return (t.stride(0), 0, t.stride(1), t.stride(2))
    return (t.stride(0), t.stride(2), t.stride(3), t.stride(1))


def _key_strides(t, kernel_layout: bool) -> tuple:
    """(b, h, s) element strides of a key-shaped tensor (or its scales)."""
    if t is None:
        return (0, 0, 0)
    if kernel_layout:
        return (t.stride(0), 0, t.stride(1))
    return (t.stride(0), t.stride(2), t.stride(1))


def flash_strides(q, k, v, out, scale_t=None) -> tuple:
    """The kernel's element strides, in its order: q (b, h, g, s), k (b, h, s),
    v (b, h, s), the scales (b, h, s), out (b, h, g, s). The bkv axis splits
    as bkv = b * nh + h; in the (BKV, ...) layout h is always 0."""
    kl = q.ndim == 4
    return (_row_strides(q, kl) + _key_strides(k, kl) + _key_strides(v, kl)
            + _key_strides(scale_t, kl) + _row_strides(out, kl))


def flash_bwd_strides(q, k, v, do, dq, dk, dv) -> tuple:
    """The backward kernels' element strides, in their order: q, do, dq as
    (b, h, g, s) and k, v, dk, dv as (b, h, s): q k v do dq dk dv."""
    kl = q.ndim == 4
    return (_row_strides(q, kl) + _key_strides(k, kl) + _key_strides(v, kl)
            + _row_strides(do, kl) + _row_strides(dq, kl) + _key_strides(dk, kl)
            + _key_strides(dv, kl))


def _check_flash_kernel(entry: str, nbkv: int, g: int, d: int, tensors) -> None:
    """What the CUDA flash entry point `entry` refuses: a head dim that is
    not contiguous or not one it is built for (`FLASH_ENTRY_HEAD_DIMS`), more
    than FLASH_MAX_GROUPS groups, a grid past 65535 kv heads."""
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("the CUDA flash kernel needs a contiguous head dim")
    dims = FLASH_ENTRY_HEAD_DIMS[entry]
    if d not in dims:
        later = (" (head dim 160 is ROADMAP queue 2 item [10], interface parity)"
                 if d in FLASH_FWD_HEAD_DIMS else "")
        raise ValueError(f"the CUDA flash kernel {entry} takes head dims {dims}, "
                         f"got {d}{later}")
    if g > FLASH_MAX_GROUPS or nbkv > 65535:
        raise ValueError(f"{g} groups / {nbkv} kv heads exceed the CUDA flash "
                         f"kernel's grid ({FLASH_MAX_GROUPS} / 65535)")


def _flash_dims(nbkv, nh, g, sq, sk, d, causal, q_offset, kv_len):
    kvl = -1 if kv_len is None else max(0, int(kv_len))
    return (ctypes.c_int * 9)(nbkv, nh, g, sq, sk, d, int(bool(causal)),
                              int(q_offset), kvl)


def launch_flash(q, k, v, *, scale: float, causal: bool, q_offset: int = 0,
                 kv_len=None, k_scale=None, v_scale=None):
    """Launch the flash-attention forward on CUDA tensors, in either layout of
    `check_flash_operands`. q, k, v all float32 (-> out, m, l), all bfloat16
    (-> bf16 out, fp32 m, l), or float32 q over int8 k, v with float32
    per-position scales k_scale, v_scale (-> out). out has q's shape and
    layout, m and l are (BKV, G, Sq). Operands may be strided views (a cache
    read in place) as long as the head dim is contiguous."""
    nbkv, nh, g, sq, sk, d = check_flash_operands(q, k, v, k_scale, v_scale)
    int8 = k.dtype == torch.int8
    if int8 != (k_scale is not None):
        raise ValueError("int8 K/V take per-position scales, float32 K/V none")
    tensors = (q, k, v) + ((k_scale, v_scale) if int8 else ())
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("CUDA kernel needs every operand on one CUDA device")
    if v.dtype != k.dtype or (q.dtype, k.dtype) not in (
            (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
            (torch.float32, torch.int8)):
        raise TypeError(f"the CUDA flash kernel takes float32 or bfloat16 q, k, v of "
                        f"one type, or float32 q over int8 k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if int8 and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                 or k_scale.stride() != v_scale.stride()):
        raise TypeError(f"k_scale and v_scale must be float32 in one layout, got "
                        f"{k_scale.dtype}/{v_scale.dtype}")
    entry = ("repro_flash_fwd_q8" if int8 else "repro_flash_fwd_bf16"
             if q.dtype == torch.bfloat16 else "repro_flash_fwd_f32")
    _check_flash_kernel(entry, nbkv, g, d, (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the CUDA flash forward records no autograd graph: "
                           "differentiate through FlashAttentionFn "
                           "(kernels/flash_attention/ops.py), or call it under "
                           "torch.no_grad()")
    out = torch.empty(q.shape, device=dev, dtype=q.dtype)
    dims = _flash_dims(nbkv, nh, g, sq, sk, d, causal, q_offset, kv_len)
    strides = (ctypes.c_longlong * 17)(*flash_strides(q, k, v, out, k_scale))
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if int8:
            m = l = None
            err = lib.repro_flash_fwd_q8(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         k_scale.data_ptr(), v_scale.data_ptr(),
                                         out.data_ptr(), dims, strides, float(scale),
                                         stream)
        else:
            m = torch.empty((nbkv, g, sq), device=dev, dtype=torch.float32)
            l = torch.empty((nbkv, g, sq), device=dev, dtype=torch.float32)
            err = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      out.data_ptr(), m.data_ptr(), l.data_ptr(),
                                      dims, strides, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"CUDA flash kernel launch failed ({entry}): cudaError {err} "
                           f"(q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}, "
                           f"causal {causal}, q_offset {q_offset}, kv_len {kv_len})")
    FLASH_ENTRY_LAUNCHES[entry] += 1
    return (out, m, l) if not int8 else out


def launch_flash_bwd(q, k, v, do, m, l, delta, *, part: str, scale: float,
                     causal: bool, q_offset: int = 0, kv_len=None):
    """Launch one flash-attention backward pass on CUDA tensors, in either
    layout of `check_flash_operands`: q, k, v and do all float32 or all
    bfloat16 (do in q's layout), the forward's m and l and delta =
    rowsum(do * out), each (BKV, G, Sq) float32 contiguous. part "dq" -> dq
    in q's shape; part "dkv" -> (dk, dv) in k's shape; in the operands' type.
    Operands may be strided views with a contiguous head dim."""
    nbkv, nh, g, sq, sk, d = check_flash_operands(q, k, v)
    dev = q.device
    stats = (m, l, delta)
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, do) + stats):
        raise ValueError("CUDA kernel needs every operand on one CUDA device")
    if (q.dtype not in (torch.float32, torch.bfloat16)
            or any(t.dtype != q.dtype for t in (k, v, do))
            or any(t.dtype != torch.float32 for t in stats)):
        raise TypeError("the CUDA flash backward takes float32 or bfloat16 q, k, v, do "
                        "of one type and float32 m, l, delta, got "
                        f"{[str(t.dtype) for t in (q, k, v, do) + stats]}")
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"do {tuple(do.shape)} does not match q {tuple(q.shape)}")
    if any(tuple(t.shape) != (nbkv, g, sq) or not t.is_contiguous() for t in stats):
        raise ValueError(f"m, l and delta must be contiguous ({nbkv}, {g}, {sq})")
    if part not in ("dq", "dkv"):
        raise ValueError(f"part {part!r}: choose 'dq' or 'dkv'")
    entry = (f"repro_flash_bwd_{part}_"
             f"{'bf16' if q.dtype == torch.bfloat16 else 'f32'}")
    _check_flash_kernel(entry, nbkv, g, d, (q, k, v, do))
    dq = torch.empty(q.shape, device=dev, dtype=q.dtype) if part == "dq" else q
    dk, dv = (torch.empty(k.shape, device=dev, dtype=k.dtype),
              torch.empty(v.shape, device=dev, dtype=v.dtype)) \
        if part == "dkv" else (k, v)
    dims = _flash_dims(nbkv, nh, g, sq, sk, d, causal, q_offset, kv_len)
    strides = (ctypes.c_longlong * 24)(*flash_bwd_strides(q, k, v, do, dq, dk, dv))
    ptrs = tuple(t.data_ptr() for t in (q, k, v, do, m, l, delta))
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        outs = (dq.data_ptr(),) if part == "dq" else (dk.data_ptr(), dv.data_ptr())
        err = getattr(lib, entry)(*ptrs, *outs, dims, strides, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"CUDA flash backward launch failed ({entry}): cudaError "
                           f"{err} (q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, "
                           f"causal {causal}, q_offset {q_offset}, kv_len {kv_len})")
    FLASH_ENTRY_LAUNCHES[entry] += 1
    return dq if part == "dq" else (dk, dv)


# the (kv_lora_rank, rope_head_dim) pairs the MLA kernel is instantiated at:
# reduced and full-width deepseek-v2-236b; and the most query heads it takes
MLA_DIMS = ((32, 16), (512, 64))
MLA_MAX_HEADS = 128
# the (q, latent) types MLA attention takes; the kernels take float32 q only
# (a bf16 q enters them multiplied by the scale, rounded to bf16 and widened)
MLA_TYPES = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16), (torch.float64, torch.float64))


def check_mla_operands(q, c_kv, k_rope) -> tuple:
    """Validate the MLA attention operands, q (B, Sq, H, r + dr) over the
    latent c_kv (B, Sk, r) and the rotary key k_rope (B, Sk, dr), and return
    (b, sq, h, sk, r, dr). c_kv and k_rope are of one type; q is float32
    over a float32 latent or over a bfloat16 one (the latent cache of an
    int8 request), bfloat16 over a bfloat16 latent (training at bf16), or
    float64 over a float64 latent (the host's gradient checks)."""
    if q.ndim != 4 or c_kv.ndim != 3 or k_rope.ndim != 3:
        raise ValueError(f"expected q (B,Sq,H,r+dr), c_kv (B,Sk,r), k_rope (B,Sk,dr); got "
                         f"q {tuple(q.shape)}, c_kv {tuple(c_kv.shape)}, "
                         f"k_rope {tuple(k_rope.shape)}")
    b, sq, h, dk = q.shape
    sk, r = c_kv.shape[1], c_kv.shape[2]
    dr = k_rope.shape[2]
    if (c_kv.shape[0], k_rope.shape[0], k_rope.shape[1]) != (b, b, sk) or dk != r + dr:
        raise ValueError(f"c_kv {tuple(c_kv.shape)} / k_rope {tuple(k_rope.shape)} do not "
                         f"match q {tuple(q.shape)} (want (B, Sk, r), (B, Sk, dr) with "
                         f"r + dr = {dk})")
    if min(b, sq, h, sk, r, dr) < 1:
        raise ValueError(f"empty MLA operands: q {tuple(q.shape)}, c_kv {tuple(c_kv.shape)}, "
                         f"k_rope {tuple(k_rope.shape)}")
    if c_kv.dtype != k_rope.dtype or (q.dtype, c_kv.dtype) not in MLA_TYPES:
        raise TypeError(f"MLA attention takes q over c_kv and k_rope of one type, as "
                        f"{[f'{a}/{b}' for a, b in MLA_TYPES]} (q/latent), got "
                        f"{q.dtype}/{c_kv.dtype}/{k_rope.dtype}")
    return b, sq, h, sk, r, dr


# the MLA forward's geometry (kRows, kKeys, kSlots in csrc/flash_mla.cu): a
# row tile is 16 (position, head) rows, a key tile 16 keys, and a block's
# ring holds 48 keys (64 over a bf16 latent), which stay there across its
# row tiles
MLA_FWD_ROWS = 16
MLA_FWD_KEYS = 16
MLA_FWD_RESIDENT = 48
# blocks that run at once: one 8-warp block an SM on the H100's 132
MLA_FWD_SLOTS = 132
# the column slices the kernel is instantiated at (full width only), taken
# over at most this many keys
MLA_FWD_COLUMN_SLICES = 4
MLA_FWD_SLICE_KEYS = 64


def mla_visit_end(sq: int, sk: int, causal: bool, q_offset: int, kv_len,
                  s_first: int = 0, s_last=None) -> int:
    """The end of the keys the MLA forward visits for the rows at positions
    [s_first, s_last] (default: all Sq): the last key one of them sees + 1
    (kv_len, the causal diagonal), taken only when every one sees key 0,
    else Sk (a row that sees no key averages all Sk). `visit_end` in
    csrc/flash_mla.cu."""
    s_last = sq - 1 if s_last is None else s_last
    kv_lim = sk if kv_len is None else min(max(0, int(kv_len)), sk)
    kend = sk
    if kv_lim > 0 and (not causal or q_offset + s_first >= 0):
        kend = kv_lim
        if causal:
            kend = min(kend, q_offset + s_last + 1)
    return kend


def mla_fwd_split(b: int, rows: int, sk: int, r: int = 512) -> tuple:
    """How the MLA forward spreads its work -> (row tiles a block, column
    slices, key chunks), from the batch, the Sq * H rows of each element and
    the keys they visit (`mla_visit_end`), for latent width r. With as many
    row tiles as SMs or more: one slice, one chunk, and enough row tiles a
    block (at most 8, strided: block j takes row tiles j, j + n, ... of n
    blocks, so a causal prefill's blocks each see short and long rows) for
    about MLA_FWD_SLOTS blocks when the keys fit the ring (each key is then
    staged once a block, and a row tile's q loads while the one before
    computes), else one (blocks balance by the scheduler). With fewer: at r = 512 over at most MLA_FWD_SLICE_KEYS
    keys, the columns in MLA_FWD_COLUMN_SLICES slices (each recomputes S,
    which is cheap there); over more keys, the key tiles in about
    MLA_FWD_SLOTS / (row tiles) chunks, combined by a second kernel in
    chunk order."""
    tiles = -(-rows // MLA_FWD_ROWS)
    total = b * tiles
    key_tiles = -(-sk // MLA_FWD_KEYS)
    if total >= MLA_FWD_SLOTS:
        nrt = min(8, -(-total // MLA_FWD_SLOTS)) if sk <= MLA_FWD_RESIDENT else 1
        return nrt, 1, 1
    if sk <= MLA_FWD_SLICE_KEYS:
        return 1, (MLA_FWD_COLUMN_SLICES if r == 512 else 1), 1
    return 1, 1, max(1, min(key_tiles, MLA_FWD_SLOTS // total))


def launch_flash_mla(q, c_kv, k_rope, *, scale: float, causal: bool, q_offset: int = 0,
                     kv_len=None):
    """Launch the MLA attention forward on CUDA tensors (`check_mla_operands`'
    shapes and types): out (B, Sq, H, r) in c_kv's type, m and l (B, Sq * H)
    fp32, row s * H + h. c_kv and k_rope may be strided views (a layer of
    the stacked cache) as long as their last dim is contiguous. The work is
    spread as `mla_fwd_split` says; a key split allocates its workspace
    here and launches the combine kernel from the same entry point (one
    count in MLA_ENTRY_LAUNCHES either way). Raises for
    (r, dr) not in MLA_DIMS, more than MLA_MAX_HEADS heads, a tensor that
    needs grad, or operands off one CUDA device."""
    b, sq, h, sk, r, dr = _check_mla_kernel(q, c_kv, k_rope)
    if any(t.stride(-1) != 1 for t in (q, c_kv, k_rope)):
        raise ValueError("the CUDA MLA kernel needs a contiguous last dim")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, c_kv, k_rope)):
        raise RuntimeError("the CUDA MLA forward records no autograd graph: "
                           "differentiate through MLAAttentionFn "
                           "(kernels/flash_attention/ops.py), or call it under "
                           "torch.no_grad()")
    dev = q.device
    if dev.type != "cuda" or c_kv.device != dev or k_rope.device != dev:
        raise ValueError("CUDA kernel needs every operand on one CUDA device")
    entry = ("repro_flash_fwd_mla_bf16kv" if c_kv.dtype == torch.bfloat16
             else "repro_flash_fwd_mla_f32")
    out = torch.empty((b, sq, h, r), device=dev, dtype=c_kv.dtype)
    m = torch.empty((b, sq * h), device=dev, dtype=torch.float32)
    l = torch.empty((b, sq * h), device=dev, dtype=torch.float32)
    kvl = -1 if kv_len is None else max(0, int(kv_len))
    nrt, ncs, nks = mla_fwd_split(b, sq * h, mla_visit_end(sq, sk, causal, q_offset, kv_len), r)
    # the key chunks' parts (acc, then m, then l) when the keys are split
    ws = (torch.empty(nks * b * sq * h * (r + 2), device=dev, dtype=torch.float32)
          if nks > 1 else None)
    dims = (ctypes.c_int * 12)(b, h, sq, sk, r, dr, int(bool(causal)), int(q_offset), kvl,
                               nrt, ncs, nks)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), q.stride(2), c_kv.stride(0), c_kv.stride(1),
        k_rope.stride(0), k_rope.stride(1), out.stride(0), out.stride(1), out.stride(2))
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(q.data_ptr(), c_kv.data_ptr(), k_rope.data_ptr(),
                                  out.data_ptr(), m.data_ptr(), l.data_ptr(),
                                  None if ws is None else ws.data_ptr(), dims, strides,
                                  float(scale), stream)
    if err != 0:
        raise RuntimeError(f"CUDA MLA kernel launch failed ({entry}): cudaError {err} "
                           f"(q {tuple(q.shape)}, c_kv {tuple(c_kv.shape)} {c_kv.dtype}, "
                           f"causal {causal}, q_offset {q_offset}, kv_len {kv_len})")
    MLA_ENTRY_LAUNCHES[entry] += 1
    return out, m, l


def _check_mla_kernel(q, c_kv, k_rope) -> tuple:
    """`check_mla_operands`, and what every MLA kernel refuses besides: a q
    that is not float32, (r, dr) not in MLA_DIMS, more than MLA_MAX_HEADS
    heads, a batch past 65535."""
    b, sq, h, sk, r, dr = check_mla_operands(q, c_kv, k_rope)
    if q.dtype != torch.float32:
        raise TypeError(f"the CUDA MLA kernels take a float32 q, got {q.dtype}")
    if (r, dr) not in MLA_DIMS:
        raise ValueError(f"the CUDA MLA kernel takes (kv_lora_rank, rope_head_dim) in "
                         f"{MLA_DIMS}, got ({r}, {dr})")
    if h > MLA_MAX_HEADS or b > 65535:
        raise ValueError(f"{h} heads / batch {b} exceed the CUDA MLA kernel's "
                         f"{MLA_MAX_HEADS} / 65535")
    return b, sq, h, sk, r, dr


# the dkv pass's geometry (kKvKeys, kKvRows in csrc/flash_mla_bwd.cu): a
# block owns 32 keys and walks its row chunk in tiles of 16 rows
MLA_DKV_KEYS = 32
MLA_DKV_ROWS = 16
# the dkv pass splits its rows until about this many blocks exist (one runs
# on an SM at a time; blocks whose rows cannot touch their keys exit at once)
MLA_BWD_BLOCKS = 1056


def mla_dkv_chunks(b: int, rows: int, sk: int) -> int:
    """How many chunks the dkv pass splits each batch element's Sq * H rows
    into: enough for about MLA_BWD_BLOCKS blocks (MLA_DKV_KEYS keys by one
    chunk each), at most one per MLA_DKV_ROWS-row tile, and no chunk left
    empty (chunk c takes tiles [c * per, (c + 1) * per), per = ceil(tiles /
    nc), as the kernel does)."""
    tiles = -(-rows // MLA_DKV_ROWS)
    key_blocks = -(-sk // MLA_DKV_KEYS)
    nc = max(1, min(tiles, -(-MLA_BWD_BLOCKS // (b * key_blocks))))
    per = -(-tiles // nc)
    return -(-tiles // per)


def launch_flash_mla_bwd(q, c_kv, k_rope, do, m, l, delta, *, part: str, scale: float,
                         dscale=None, causal: bool, q_offset: int = 0, kv_len=None):
    """Launch one MLA backward pass on contiguous CUDA tensors: q (B, Sq, H,
    r + dr) float32, c_kv (B, Sk, r), k_rope (B, Sk, dr) and do (B, Sq, H, r)
    all float32 or all bfloat16, the forward's m and l and delta =
    rowsum(do * out), each (B, Sq * H) float32. Scores are (q * scale) .
    [c_kv ; k_rope]. part "dq" -> dq (q's shape, in the latent's type), the
    gradient of q * scale times `dscale` (default `scale`); part "dkv" ->
    (dc_kv, dk_rope) in the latent's type. Raises as `launch_flash_mla` does
    and for a tensor that is not contiguous."""
    b, sq, h, sk, r, dr = _check_mla_kernel(q, c_kv, k_rope)
    dev = q.device
    stats = (m, l, delta)
    if do.dtype != c_kv.dtype or any(t.dtype != torch.float32 for t in stats):
        raise TypeError(f"the CUDA MLA backward takes do in the latent's type and float32 "
                        f"m, l, delta, got {[str(t.dtype) for t in (c_kv, do) + stats]}")
    if tuple(do.shape) != (b, sq, h, r):
        raise ValueError(f"do {tuple(do.shape)} does not match out ({b}, {sq}, {h}, {r})")
    if any(tuple(t.shape) != (b, sq * h) for t in stats):
        raise ValueError(f"m, l and delta must be ({b}, {sq * h})")
    if not all(t.is_contiguous() for t in (q, c_kv, k_rope, do) + stats):
        raise ValueError("the CUDA MLA backward needs contiguous operands")
    if part not in ("dq", "dkv"):
        raise ValueError(f"part {part!r}: choose 'dq' or 'dkv'")
    if dev.type != "cuda" or any(t.device != dev for t in (c_kv, k_rope, do) + stats):
        raise ValueError("CUDA kernel needs every operand on one CUDA device")
    entry = (f"repro_flash_bwd_mla_{part}_"
             f"{'bf16' if c_kv.dtype == torch.bfloat16 else 'f32'}")
    nc = mla_dkv_chunks(b, sq * h, sk)
    kvl = -1 if kv_len is None else max(0, int(kv_len))
    dims = (ctypes.c_int * 10)(b, h, sq, sk, r, dr, int(bool(causal)), int(q_offset), kvl, nc)
    ptrs = tuple(t.data_ptr() for t in (q, c_kv, k_rope, do, m, l, delta))
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if part == "dq":
            dq = torch.empty(q.shape, device=dev, dtype=c_kv.dtype)
            err = getattr(lib, entry)(*ptrs, dq.data_ptr(), dims, float(scale),
                                      float(scale if dscale is None else dscale), stream)
            res = dq
        else:
            scratch = torch.empty((nc, b, sk, r + dr), device=dev, dtype=torch.float32)
            dc = torch.empty(c_kv.shape, device=dev, dtype=c_kv.dtype)
            dkr = torch.empty(k_rope.shape, device=dev, dtype=k_rope.dtype)
            err = getattr(lib, entry)(*ptrs, scratch.data_ptr(), dc.data_ptr(),
                                      dkr.data_ptr(), dims, float(scale), stream)
            res = (dc, dkr)
    if err != 0:
        raise RuntimeError(f"CUDA MLA backward launch failed ({entry}): cudaError {err} "
                           f"(q {tuple(q.shape)}, c_kv {tuple(c_kv.shape)} {c_kv.dtype}, "
                           f"causal {causal}, q_offset {q_offset}, kv_len {kv_len})")
    MLA_ENTRY_LAUNCHES[entry] += 1
    return res


# the state sizes the selective scan is instantiated at: reduced and
# full-width jamba (the reference's configs use no other)
SCAN_STATE_DIMS = (8, 16)
# the backward's channels a block (kBwdChannels in selective_scan.cu) and
# steps a chunk (kChunk: the checkpoint interval, and the steps whose states
# a lane keeps in registers); `library()` checks them against the kernel's
SCAN_BWD_CHANNELS = 32
SCAN_CHUNK = 8


def scan_bwd_scratch(batch: int, s: int, di: int, n: int) -> dict:
    """The selective scan backward's scratch, {name: shape}, all fp32: ck,
    the state at the start of every chunk of SCAN_CHUNK steps but the first
    and the last (B, max(chunks - 2, 0), di, N); pbc, each block of
    SCAN_BWD_CHANNELS channels' dB and dC sums (blocks, B, S, 2N); pa, dA per
    batch element (B, di, N); pd, dD's (B, di)."""
    blocks = -(-di // SCAN_BWD_CHANNELS)
    chunks = -(-s // SCAN_CHUNK)
    return {"ck": (batch, max(chunks - 2, 0), di, n), "pbc": (blocks, batch, s, 2 * n),
            "pa": (batch, di, n), "pd": (batch, di)}


def check_scan_geometry(kernel: tuple) -> None:
    """Raise unless the backward kernel's (channels a block, steps a
    chunk) are the ones `scan_bwd_scratch` sizes its scratch by: a scratch
    sized for other ones would be written out of bounds."""
    if tuple(kernel) != (SCAN_BWD_CHANNELS, SCAN_CHUNK):
        raise RuntimeError(f"selective_scan.cu's backward takes (channels a block, steps a "
                           f"chunk) {tuple(kernel)}, but kernels/cuda.py sizes its scratch "
                           f"for {(SCAN_BWD_CHANNELS, SCAN_CHUNK)}")


def check_scan_operands(x, dt, a, b, c, d, z, h0) -> tuple:
    """Validate the selective scan's operands, x, dt, z (B, S, di) and d
    (di,) of one floating type (the activations'), b and c (B, S, N), a
    (di, N) and h0 (B, di, N) float32 (float64 with float64 activations:
    the host's gradient checks), and return (batch, s, di, n)."""
    if x.ndim != 3 or b.ndim != 3 or a.ndim != 2:
        raise ValueError(f"expected x (B,S,di), b (B,S,N), a (di,N); got x {tuple(x.shape)}, "
                         f"b {tuple(b.shape)}, a {tuple(a.shape)}")
    batch, s, di = x.shape
    n = a.shape[1]
    want = {"dt": (dt, (batch, s, di)), "z": (z, (batch, s, di)), "b": (b, (batch, s, n)),
            "c": (c, (batch, s, n)), "a": (a, (di, n)), "d": (d, (di,)),
            "h0": (h0, (batch, di, n))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match x {tuple(x.shape)} "
                             f"and a {tuple(a.shape)} (want {shape})")
    if min(batch, s, di, n) < 1:
        raise ValueError(f"empty selective scan operands: x {tuple(x.shape)}, "
                         f"a {tuple(a.shape)}")
    state = torch.float64 if x.dtype == torch.float64 else torch.float32
    if (any(t.dtype != state for t in (a, b, c, h0)) or not x.dtype.is_floating_point
            or any(t.dtype != x.dtype for t in (dt, d, z))):
        raise TypeError(f"the selective scan takes x, dt, d, z of one floating type and "
                        f"float32 a, b, c, h0; got x {x.dtype}, dt {dt.dtype}, d {d.dtype}, "
                        f"z {z.dtype}, a {a.dtype}, b {b.dtype}, c {c.dtype}, h0 {h0.dtype}")
    return batch, s, di, n


def _check_scan_kernel(args, contiguous: bool) -> tuple:
    """`check_scan_operands`, and what the CUDA scan refuses besides:
    activations other than float32 or bfloat16, N not in SCAN_STATE_DIMS, a
    batch past 65535, operands off one CUDA device, a last dim (or, with
    `contiguous`, any operand) that is not contiguous; returns (batch, s,
    di, n, entry suffix)."""
    x, dt, a, b, c, d, z, h0 = args[:8]
    batch, s, di, n = check_scan_operands(x, dt, a, b, c, d, z, h0)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA selective scan takes float32 or bfloat16 activations, "
                        f"got {x.dtype}")
    if contiguous:
        if not all(t.is_contiguous() for t in args):
            raise ValueError("the CUDA selective scan backward needs contiguous operands")
    else:
        if any(t.stride(-1) != 1 for t in (x, dt, z, b, c)):
            raise ValueError("the CUDA selective scan needs a contiguous last dim")
        if not all(t.is_contiguous() for t in (a, d, h0)):
            raise ValueError("the CUDA selective scan needs contiguous a, d and h0")
    if n not in SCAN_STATE_DIMS:
        raise ValueError(f"the CUDA selective scan takes a state dim (ssm_state_dim) in "
                         f"{SCAN_STATE_DIMS}, got {n}")
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the CUDA selective scan's 65535")
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in args):
        raise ValueError("CUDA kernel needs every operand on one CUDA device")
    return batch, s, di, n, "bf16" if x.dtype == torch.bfloat16 else "f32"


def launch_selective_scan(x, dt, a, b, c, d, z, h0):
    """Launch the selective scan on CUDA tensors (`check_scan_operands`'
    shapes; float32 or bfloat16 activations): out (B, S, di) in x's type and
    h_last (B, di, N) fp32. x, dt, z, b and c may be strided views with a
    contiguous last dim; a, d and h0 must be contiguous. Raises for N not in
    SCAN_STATE_DIMS, a tensor that needs grad, or operands off one CUDA
    device."""
    args = (x, dt, a, b, c, d, z, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("the CUDA selective scan records no autograd graph: "
                           "differentiate through SelectiveScanFn "
                           "(kernels/selective_scan/kernel.py), or call it under "
                           "torch.no_grad()")
    batch, s, di, n, sfx = _check_scan_kernel(args, contiguous=False)
    dev = x.device
    out = torch.empty((batch, s, di), device=dev, dtype=x.dtype)
    h_last = torch.empty((batch, di, n), device=dev, dtype=torch.float32)
    dims = (ctypes.c_int * 4)(batch, s, di, n)
    strides = (ctypes.c_longlong * 10)(*(st for t in (x, dt, z, b, c)
                                         for st in (t.stride(0), t.stride(1))))
    entry = f"repro_selective_scan_{sfx}"
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in (x, dt, z, b, c, a, d, h0, out, h_last)), dims, strides,
            stream)
    if err != 0:
        raise RuntimeError(f"CUDA selective scan launch failed ({entry}): cudaError {err} "
                           f"(x {tuple(x.shape)} {x.dtype}, N {n})")
    SCAN_ENTRY_LAUNCHES[entry] += 1
    return out, h_last


def launch_selective_scan_bwd(x, dt, a, b, c, d, z, h0, dout, dh_last):
    """Launch the selective scan's backward on contiguous CUDA tensors: the
    forward's operands, dout (B, S, di) in the activations' type and dh_last
    (B, di, N) fp32 -> (dx, ddt, da, db, dc, dd, dz, dh0), each in its
    operand's type. Raises as `launch_selective_scan` does, and for a
    tensor that is not contiguous."""
    args = (x, dt, a, b, c, d, z, h0, dout, dh_last)
    batch, s, di, n, sfx = _check_scan_kernel(args, contiguous=True)
    if dout.dtype != x.dtype or tuple(dout.shape) != tuple(x.shape):
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if dh_last.dtype != torch.float32 or tuple(dh_last.shape) != tuple(h0.shape):
        raise ValueError(f"dh_last {tuple(dh_last.shape)} {dh_last.dtype} does not match h0 "
                         f"{tuple(h0.shape)} float32")
    dev = x.device

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, device=dev, dtype=dtype)

    dx, ddt, dz = (empty((batch, s, di), x.dtype) for _ in range(3))
    dh0, db, dc, da, dd = (empty(h0.shape), empty(b.shape), empty(c.shape), empty(a.shape),
                           empty(d.shape, d.dtype))
    scratch = tuple(map(empty, scan_bwd_scratch(batch, s, di, n).values()))
    dims = (ctypes.c_int * 4)(batch, s, di, n)
    entry = f"repro_selective_scan_bwd_{sfx}"
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in (x, dt, z, b, c, a, d, h0, dout, dh_last, dx, ddt, dz, dh0)
              + scratch + (db, dc, da, dd)), dims, stream)
    if err != 0:
        raise RuntimeError(f"CUDA selective scan backward launch failed ({entry}): cudaError "
                           f"{err} (x {tuple(x.shape)} {x.dtype}, N {n})")
    SCAN_ENTRY_LAUNCHES[entry] += 1
    return dx, ddt, da, db, dc, dd, dz, dh0
