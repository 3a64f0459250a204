"""Build and load the CUDA kernels of ``csrc/``.

Each ``.cu`` file compiles with ``nvcc`` into its own shared library with
a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). The libraries go to ``build/repro_torch/<hash>/``
at the repository root, keyed by a hash of every source and the flags,
so an edited source never loads a stale library. Nothing is built when
this module is imported: :func:`load` builds on first CUDA use, and the
``nvcc`` processes (one per source) run in parallel.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("xnor_gemm", "fused_gemm", "direct_conv", "megakernel_conv_stage",
           "megakernel_chain", "pack_rows", "unpack_gemm", "ssm_scan",
           "flash_attention", "mlstm_chunk", "flash_attention_bwd",
           "ssm_scan_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
# C signature of every exported function: all pointers (arrays of pointers
# and of ints included) and the stream as void*, sizes as int, element
# strides as long long, scalars as float; each launcher returns
# cudaGetLastError() as an int.
_SIGNATURES = {
    # (w, x, out, partial, M, KW, N, k_bits, splits, tile_n, stream);
    # tile_n 0 takes the C heuristic
    "repro_xnor_gemm": (_P,) * 4 + (_I,) * 6 + (_P,),
    # (M, KW, N) -> K splits (scratch [splits, M, N] int32 when above 1)
    "repro_xnor_gemm_splits": (_I, _I, _I),
    # (M, N) -> the tile width the C heuristic picks
    "repro_xnor_gemm_tile_n": (_I, _I),
    # (w, x, a, b, out, partial, M, KW, N, k_bits, splits, tile_n, stream)
    "repro_fused_xnor_gemm": (_P,) * 6 + (_I,) * 6 + (_P,),
    # (x, w, a, b, out, N, H, W, CW, D, kh, kw, stride, pad, k_bits, tile_n,
    #  stream); x the unpadded map
    "repro_fused_direct_conv": (_P,) * 5 + (_I,) * 11 + (_P,),
    # (x, w, out, N, H, W, CW, D, kh, kw, stride, pad, k_bits, tile_n,
    #  stream); x the unpadded map
    "repro_direct_conv_dot": (_P, _P, _P) + (_I,) * 11 + (_P,),
    # (x, out, w[], a[], b[], d_words[], cw[], k_bits[], n_layers, n_images,
    #  hp, wp, kh, kw, pad, pool, cluster, stream); x the unpadded map, hp
    #  and wp its padded sizes
    "repro_megakernel_conv_stage": (_P,) * 8 + (_I,) * 9 + (_P,),
    # (d_words[], cw[], n_layers, hp, wp, kh, kw, pad, cluster,
    #  &smem_bytes, &max_clusters)
    "repro_megakernel_conv_stage_limits": (_P, _P) + (_I,) * 7 + (_P, _P),
    # (w, a, b, x, wf, out, kw_layer[], k_bits[], n_layers, m_max, kw_max,
    #  kw_act, mf, kwf, final_k_bits, n, n_real, cluster, stream)
    "repro_megakernel_chain": (_P,) * 8 + (_I,) * 10 + (_P,),
    # (kw_layer[], n_layers, m_max, kw_act, mf, kwf, cluster, &smem_bytes,
    #  &max_clusters)
    "repro_megakernel_chain_limits": (_P,) + (_I,) * 6 + (_P, _P),
    # (x, out, KW, N, stride_n, stream)
    "repro_pack_rows": (_P, _P, _I, _I, _L, _P),
    # (w, x, out, scratch, M, KW, N, stride_k, stride_n, x_is_bf16, splits,
    #  stream)
    "repro_unpack_gemm": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _I, _P),
    # (M, KW, N) -> K splits (scratch [splits, M, N] when above 1)
    "repro_unpack_gemm_splits": (_I, _I, _I),
    # (dt, xh, B, C, A, h0, y, h_out, batch, chunk, di, ds, then the batch
    #  and time strides of dt, xh, B and C, stream)
    "repro_ssm_scan_chunk": (_P,) * 8 + (_I,) * 4 + (_L,) * 8 + (_P,),
    # (dt, xh, B, C, A, h0, dy, dh_last, d dt, d xh, d B, d C, d A, d h0,
    #  scratch; batch, chunk, di, ds, then the batch and time strides of
    #  dt, xh, B and C, stream)
    "repro_ssm_scan_chunk_bwd": (_P,) * 15 + (_I,) * 4 + (_L,) * 8 + (_P,),
    # (batch, chunk, di, ds, &floats): the scratch the backward needs
    "repro_ssm_scan_chunk_bwd_scratch": (_I,) * 4 + (_P,),
    # (q, k, v, out, lse, BH, Sq, Skv, Dh, causal, is_bf16, scale, stream);
    # lse [BH, Sq] float32
    "repro_flash_attention": (_P,) * 5 + (_I,) * 6 + (_F, _P),
    # (q, k, v, o, lse, do, delta, dq, dk, dv, BH, Sq, Skv, Dh, causal,
    #  is_bf16, scale, stream); delta [BH, Sq] float32 scratch
    "repro_flash_attention_bwd": (_P,) * 10 + (_I,) * 6 + (_F, _P),
    # (q, k, v, logi, logf, y, C, n, m, then the scratch sw, g, m_loc,
    #  inter, wk, decay, chunk ends, states, n states; BH, S, L, dk, dv,
    #  stream)
    "repro_mlstm_chunked": (_P,) * 18 + (_I,) * 5 + (_P,),
    # (q, k, v, logi, logf, y, states, nstates, dy, dC or NULL, dn or NULL,
    #  dq, dk, dv, dlogi, dlogf, then the scratch sw, dsw, dnum, prod,
    #  dC_out, dn_out, vec, cvec; BH, S, L, dk, dv, stream)
    "repro_mlstm_chunked_bwd": (_P,) * 24 + (_I,) * 5 + (_P,),
}
_LIB_OF = {
    "repro_xnor_gemm": "xnor_gemm",
    "repro_xnor_gemm_splits": "xnor_gemm",
    "repro_xnor_gemm_tile_n": "xnor_gemm",
    "repro_fused_xnor_gemm": "fused_gemm",
    "repro_fused_direct_conv": "direct_conv",
    "repro_direct_conv_dot": "direct_conv",
    "repro_megakernel_conv_stage": "megakernel_conv_stage",
    "repro_megakernel_conv_stage_limits": "megakernel_conv_stage",
    "repro_megakernel_chain": "megakernel_chain",
    "repro_megakernel_chain_limits": "megakernel_chain",
    "repro_pack_rows": "pack_rows",
    "repro_unpack_gemm": "unpack_gemm",
    "repro_unpack_gemm_splits": "unpack_gemm",
    "repro_ssm_scan_chunk": "ssm_scan",
    "repro_ssm_scan_chunk_bwd": "ssm_scan_bwd",
    "repro_ssm_scan_chunk_bwd_scratch": "ssm_scan_bwd",
    "repro_flash_attention": "flash_attention",
    "repro_flash_attention_bwd": "flash_attention_bwd",
    "repro_mlstm_chunked": "mlstm_chunk",
    "repro_mlstm_chunked_bwd": "mlstm_chunk",
}

_loaded: dict[str, ctypes._CFuncPtr] = {}


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> pathlib.Path:
    return BUILD_ROOT / source_hash()


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "repro_torch are built from source on first CUDA use")


def build() -> dict:
    """Compile every missing library, all ``nvcc`` runs in parallel.

    Returns ``{"dir", "seconds", "built": [names], "ptxas": {name: log}}``;
    raises ``RuntimeError`` with the compiler's output if a build fails.
    Processes that start together (one a device) build once: each takes
    an exclusive lock on the build directory, and the ones that follow
    find the libraries there.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build(out_dir)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build(out_dir: pathlib.Path) -> dict:
    t0 = time.monotonic()
    missing = [n for n in SOURCES if not (out_dir / f"{n}.so").exists()]
    compiler = nvcc() if missing else ""
    procs = {}
    for name in missing:
        tmp = out_dir / f"{name}.{os.getpid()}.tmp.so"
        procs[name] = (tmp, subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out_dir / f"{name}.so")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    ptxas = {}
    for name in SOURCES:
        log = out_dir / f"{name}.log"
        ptxas[name] = log.read_text() if log.exists() else ""
    return {"dir": str(out_dir), "seconds": time.monotonic() - t0,
            "built": sorted(procs), "ptxas": ptxas}


def load(symbol: str) -> ctypes._CFuncPtr:
    """The launcher ``symbol`` with its argtypes set, building first if
    the libraries for the current sources are missing."""
    fn = _loaded.get(symbol)
    if fn is None:
        path = build_dir() / f"{_LIB_OF[symbol]}.so"
        if not path.exists():
            build()
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = list(_SIGNATURES[symbol])
        fn.restype = ctypes.c_int
        _loaded[symbol] = fn
    return fn
