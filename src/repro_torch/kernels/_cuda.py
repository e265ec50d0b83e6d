"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded through ``ctypes``.
Nothing is built when a module is imported: the first CUDA launch (or
``build_all``) builds, into ``build/repro_torch/`` under the checkout, and
the library's file name carries a hash of its source, so an edited source
is rebuilt and an unchanged one is reused.

K1 and K4 include ``csrc/hopper.cuh`` (mbarriers, TMA, wgmma), so the
hash covers the headers too.  ``nvcc`` runs with ``-Xptxas -v``; its
report (registers, shared memory and spills of each kernel) is kept
beside the library as ``lib<name>-<hash>.log`` (``ptxas_report``).

``LAUNCHES`` holds one plain integer per kernel wrapper; a wrapper adds
one exactly where it launches its kernel (``count``).  A launch of a
variant (gemma2's 'local' window, the softcap, llama4's 'chunked' kind)
also adds one to the variant's own key, ``"<kernel>:<variant>"``, e.g.
``"paged_decode:local+softcap"`` or ``"paged_decode:chunked+chunk"``;
K6's prefill-chunk body counts under ``paged_decode`` with the ``chunk``
variant (``paged_decode:chunk``, ``paged_decode:local+softcap+chunk``),
and its decode body never does.
A row pass fused into a GEMM's store phase is no launch of its own: it
counts as the GEMM's variant (``matmul:norm``, ``int8_matmul:norm``,
``int8_matmul:quantize``), while ``rmsnorm``, ``quantize`` and
``int8_quantize`` count the row kernels' own launches.  The training
path's kernels count as K1's fp32 store ``matmul:f32``, K4 with its
log-sum-exp output ``flash_attention:lse``, and K4's backward (one call,
three launches, the row dots and the dK/dV and dQ passes:
``csrc/flash_backward.cu``) ``flash_attention_bwd``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every exported launcher: (argtypes); each returns the
# cudaError_t of its launch
SIGNATURES: Dict[str, Dict[str, List]] = {
    "matmul": {
        # a, b, out, residual, operand2, workspace, counters, norm_scale,
        # normed, M, N, K, splits, tile_n, epi_flags (1 silu gate, 2
        # gelu), eps, stream
        "k1_matmul": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _I, _I, _F, _P],
        # a, b, out (fp32), workspace, counters, M, N, K, splits, tile_n,
        # stream: K1's fp32 store (the weight gradients)
        "k1_matmul_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # x, scale, out, M, N, eps, stream
        "k1_rmsnorm_rows": [_P, _P, _P, _I, _I, _F, _P],
        # a, b ([N, K]), a_scale, b_scale, out_f32, out_bf16, residual,
        # operand2, workspace, counters, norm_scale, normed, q, q_scale, M,
        # N, K, splits, tile_n, epi_flags, eps, stream
        "k2_int8_matmul": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
        # x, q, scale, M, N, x_is_f32, stream
        "k3_quantize_rows": [_P, _P, _P, _I, _I, _I, _P],
        # stream: an empty kernel, the launch floor (a measurement only)
        "k0_empty": [_P],
    },
    "flash_attention": {
        # q, k, v, out, B, Sq, Skv, H, KV, hd, scale, mask kind
        # (flash_attention.MASK_CODES), window, prefix_len, softcap, stream
        "k4_flash_prefill": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                             _I, _I, _F, _P],
        # q, k, v, out, lse, then as k4_flash_prefill
        "k4_flash_prefill_lse": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _F, _I, _I, _I, _F, _P],
        # q, k, v, ws, out, counters, B, KV, rep, G, hd, cache_len, pos,
        # n_tiles, n_splits, scale, softcap, stream
        "k5_flash_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _F, _F, _P],
        # q, k_pool, v_pool, table, positions, ws, out, counters, L, KV,
        # rep, G, hd, P, PS, n_tiles, n_splits, scale, mask kind, window,
        # softcap, stream
        "k6_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _F, _I, _I, _F, _P],
        # q, k_pool, v_pool, table, positions, out, L, S, KV, G, hd, P,
        # log2 PS, n_pool, scale, mask kind, window, softcap, stream
        "k6_paged_chunk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, _F, _I, _I, _F, _P],
    },
    "flash_backward": {
        # q, k, v, out, dout, lse, dq, dk, dv, ws, B, S, H, KV, hd, scale,
        # mask kind, window, prefix_len, softcap, stream
        "k4_flash_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _I, _F, _I, _I, _I, _F, _P],
    },
    "addertree": {
        # partials, out, S, n, in_kind, out_kind, stream
        "k7_addertree": [_P, _P, _I, ctypes.c_longlong, _I, _I, _P],
    },
}

LAUNCHES: Dict[str, int] = {"matmul": 0, "rmsnorm": 0,
                            "int8_matmul": 0, "int8_quantize": 0,
                            "quantize": 0, "flash_attention": 0,
                            "flash_decode": 0, "paged_decode": 0,
                            "addertree": 0, "flash_attention_bwd": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count(name: str, **variants: bool) -> None:
    """One launch of kernel ``name``; where variants are on, also one of
    ``"<name>:<variant>+..."`` (in the order given)."""
    LAUNCHES[name] += 1
    key = variant_key(name, **variants)
    if key != name:
        LAUNCHES[key] = LAUNCHES.get(key, 0) + 1


def variant_key(name: str, **variants: bool) -> str:
    """The key ``count`` adds one to beside ``name`` for these variants:
    ``"<name>:<variant>+..."`` of those on, in the order given, or
    ``name`` itself where none is on."""
    on = [v for v, flag in variants.items() if flag]
    return f"{name}:{'+'.join(on)}" if on else name


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit on the machine with the "
                           "card")
    return found


def _target(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns the
    process (or None) and the library path."""
    so = _target(name)
    if so.exists():
        return None, so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp
    return proc, so


def _finish_build(proc, so: Path) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {so.name}:\n{out}")
    so.with_suffix(".log").write_text(out)
    os.replace(proc.tmp, so)


def ptxas_report(so: Path) -> List[str]:
    """The ptxas lines of a library's build: per kernel, its registers,
    shared memory and spill stores/loads (empty if the log is gone)."""
    log = so.with_suffix(".log")
    if not log.exists():
        return []
    return [line.strip() for line in log.read_text().splitlines()
            if "Compiling entry" in line or "registers" in line
            or "spill" in line]


def _load(name: str, so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def build_all() -> Dict[str, Path]:
    """Build every kernel library at once (one nvcc per source, all
    started together) and load them.  Returns the library paths."""
    started = {name: _start_build(name) for name in SIGNATURES}
    for name, (proc, so) in started.items():
        _finish_build(proc, so)
        if name not in _LIBS:
            _load(name, so)
    return {name: so for name, (_, so) in started.items()}


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        proc, so = _start_build(name)
        _finish_build(proc, so)
        _load(name, so)
    return _LIBS[name]


_FNS: Dict[tuple, ctypes._CFuncPtr] = {}
# the current stream's handle without building a Stream object (the
# decode loop is host-bound, and every launch asks for it); absent from
# CPU builds, where nothing launches
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream() -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


def launch(name: str, fn: str, *args) -> None:
    """Call one exported launcher on PyTorch's current stream and raise if
    the launch was refused."""
    f = _FNS.get((name, fn))
    if f is None:
        f = _FNS[name, fn] = getattr(lib(name), fn)
    err = f(*args, _stream())
    if err != 0:
        raise RuntimeError(f"CUDA launch of {fn} failed with cudaError {err}")


def check(t: torch.Tensor, what: str, dtype: torch.dtype, shape=None,
          align: int = 16) -> None:
    """Wrapper-side validation before a pointer reaches a kernel: device,
    dtype, shape, contiguity and ``align``-byte alignment."""
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{what} must be {align}-byte aligned")
