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
`launch_flash` (the flash attention forward on the split-TF32 tensor cores;
int8 K/V is dequantized as it is staged into the same body) and
`launch_flash_bwd` (its two backward passes, on the split-TF32 tensor cores
too) are the launch sites: they check
device, dtype, layout and shapes, allocate the outputs with `torch.empty`,
launch on PyTorch's current stream without synchronising, and raise on a
nonzero `cudaGetLastError()`. The conv and BSR kernels take contiguous
operands; the flash kernel reads its operands through element strides.
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
SOURCES = ("ecr_conv.cu", "ecr_conv_int8.cu", "bsr_matmul.cu", "bsr_matmul_int8.cu",
           "flash_attention.cu", "flash_attention_bwd.cu")
HEADERS = ("smem_io.cuh", "int8_mma.cuh", "tf32_mma.cuh")  # included; hashed
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
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
            bsr_ints = [ctypes.c_int] * 6
            lib.repro_bsr_matmul_f32.argtypes = ptrs + bsr_ints + [ctypes.c_void_p]
            lib.repro_bsr_matmul_f32.restype = ctypes.c_int
            lib.repro_bsr_matmul_i8.argtypes = [ctypes.c_void_p] * 7 + bsr_ints + [ctypes.c_void_p]
            lib.repro_bsr_matmul_i8.restype = ctypes.c_int
            dims = ctypes.POINTER(ctypes.c_int)
            strides = ctypes.POINTER(ctypes.c_longlong)
            lib.repro_flash_fwd_f32.argtypes = [ctypes.c_void_p] * 6 + [
                dims, strides, ctypes.c_float, ctypes.c_void_p]
            lib.repro_flash_fwd_f32.restype = ctypes.c_int
            lib.repro_flash_fwd_q8.argtypes = [ctypes.c_void_p] * 6 + [
                dims, strides, ctypes.c_float, ctypes.c_void_p]
            lib.repro_flash_fwd_q8.restype = ctypes.c_int
            lib.repro_flash_bwd_dq_f32.argtypes = [ctypes.c_void_p] * 8 + [
                dims, strides, ctypes.c_float, ctypes.c_void_p]
            lib.repro_flash_bwd_dq_f32.restype = ctypes.c_int
            lib.repro_flash_bwd_dkv_f32.argtypes = [ctypes.c_void_p] * 9 + [
                dims, strides, ctypes.c_float, ctypes.c_void_p]
            lib.repro_flash_bwd_dkv_f32.restype = ctypes.c_int
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


FLASH_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
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


def _check_flash_kernel(nbkv: int, g: int, d: int, tensors) -> None:
    """What every CUDA flash kernel refuses: a head dim that is not
    contiguous or not one they are built for, more than FLASH_MAX_GROUPS
    groups, a grid past 65535 kv heads."""
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("the CUDA flash kernel needs a contiguous head dim")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernel takes head dims {FLASH_HEAD_DIMS}, got {d}")
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
    `check_flash_operands`. q float32; k, v float32 (-> out, m, l) or int8
    with float32 per-position scales k_scale, v_scale (-> out). out has q's
    shape and layout, m and l are (BKV, G, Sq). Operands may be strided
    views (a cache read in place) as long as the head dim is contiguous."""
    nbkv, nh, g, sq, sk, d = check_flash_operands(q, k, v, k_scale, v_scale)
    int8 = k.dtype == torch.int8
    if int8 != (k_scale is not None):
        raise ValueError("int8 K/V take per-position scales, float32 K/V none")
    tensors = (q, k, v) + ((k_scale, v_scale) if int8 else ())
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("CUDA kernel needs every operand on one CUDA device")
    if q.dtype != torch.float32 or v.dtype != k.dtype or k.dtype not in (
            torch.float32, torch.int8):
        raise TypeError(f"the CUDA flash kernel takes float32 q and float32 or "
                        f"int8 k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if int8 and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                 or k_scale.stride() != v_scale.stride()):
        raise TypeError(f"k_scale and v_scale must be float32 in one layout, got "
                        f"{k_scale.dtype}/{v_scale.dtype}")
    _check_flash_kernel(nbkv, g, d, (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the CUDA flash forward records no autograd graph: "
                           "differentiate through FlashAttentionFn "
                           "(kernels/flash_attention/ops.py), or call it under "
                           "torch.no_grad()")
    out = torch.empty(q.shape, device=dev, dtype=torch.float32)
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
            err = lib.repro_flash_fwd_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                          out.data_ptr(), m.data_ptr(), l.data_ptr(),
                                          dims, strides, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"CUDA flash kernel launch failed: cudaError {err} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)} {k.dtype}, "
                           f"causal {causal}, q_offset {q_offset}, kv_len {kv_len})")
    return (out, m, l) if not int8 else out


def launch_flash_bwd(q, k, v, do, m, l, delta, *, part: str, scale: float,
                     causal: bool, q_offset: int = 0, kv_len=None):
    """Launch one flash-attention backward pass on CUDA tensors, in either
    layout of `check_flash_operands`: float32 q, k, v and do (do in q's
    layout), the forward's m and l and delta = rowsum(do * out), each
    (BKV, G, Sq) float32 contiguous. part "dq" -> dq in q's shape; part
    "dkv" -> (dk, dv) in k's shape. Operands may be strided views with a
    contiguous head dim."""
    nbkv, nh, g, sq, sk, d = check_flash_operands(q, k, v)
    dev = q.device
    stats = (m, l, delta)
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, do) + stats):
        raise ValueError("CUDA kernel needs every operand on one CUDA device")
    if any(t.dtype != torch.float32 for t in (q, k, v, do) + stats):
        raise TypeError("the CUDA flash backward takes float32 operands, got "
                        f"{[str(t.dtype) for t in (q, k, v, do) + stats]}")
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"do {tuple(do.shape)} does not match q {tuple(q.shape)}")
    if any(tuple(t.shape) != (nbkv, g, sq) or not t.is_contiguous() for t in stats):
        raise ValueError(f"m, l and delta must be contiguous ({nbkv}, {g}, {sq})")
    if part not in ("dq", "dkv"):
        raise ValueError(f"part {part!r}: choose 'dq' or 'dkv'")
    _check_flash_kernel(nbkv, g, d, (q, k, v, do))
    dq = torch.empty(q.shape, device=dev, dtype=torch.float32) if part == "dq" else q
    dk, dv = (torch.empty(k.shape, device=dev, dtype=torch.float32),
              torch.empty(v.shape, device=dev, dtype=torch.float32)) \
        if part == "dkv" else (k, v)
    dims = _flash_dims(nbkv, nh, g, sq, sk, d, causal, q_offset, kv_len)
    strides = (ctypes.c_longlong * 24)(*flash_bwd_strides(q, k, v, do, dq, dk, dv))
    ptrs = tuple(t.data_ptr() for t in (q, k, v, do, m, l, delta))
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if part == "dq":
            err = lib.repro_flash_bwd_dq_f32(*ptrs, dq.data_ptr(), dims, strides,
                                             float(scale), stream)
        else:
            err = lib.repro_flash_bwd_dkv_f32(*ptrs, dk.data_ptr(), dv.data_ptr(), dims,
                                              strides, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"CUDA flash backward ({part}) launch failed: cudaError "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, causal "
                           f"{causal}, q_offset {q_offset}, kv_len {kv_len})")
    return dq if part == "dq" else (dk, dv)
