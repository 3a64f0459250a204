"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--parent-src DIR]

1. Prints the card (``nvidia-smi``), torch and CUDA versions.
2. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. Runs each kernel at every shape its main path gives it and holds its
   output, bit for bit, against its plain-torch twin on the same inputs;
   times kernel, twin and a PyTorch library yardstick (fp32
   ``torch.matmul`` / ``F.conv2d`` of the unpacked ±1 operands, TF32
   off; none for ``pack_rows``) with CUDA events. The slice-1 kernels
   run at the batch-32 serving shapes. The two megakernels run at the
   three conv-stage shapes (and once more at batch 3) and at the FC
   trunk (batch 32 and masked tails of 1, 3 and 13 columns); beside
   them the slice-1 per-layer kernels over the same layers are timed.
   The unfused PACKED kernels run at the eight binary layers of the
   Table 2 forward at its batch of 64 (these times make their totals),
   and again at batch 32: ``pack_rows`` on the transposed patch matrix
   it reads in place, timed with a cold L2 as its HBM bound assumes;
   ``direct_conv`` at the five convs; ``unpack_gemm`` on ±1 input
   (exact) and on real input in [-1, 1], held within rtol 1e-5 / atol
   1e-4 of the float64-accumulated dot, and the same at jamba's decode
   shape (one packed [8192, 8192] expert, bf16 X [8192, 4]; yardstick
   bf16 ``torch.matmul``; not summed). The two kernels redesigned last,
   ``direct_conv`` (``direct_conv_dot``) and ``ssm_scan_chunk``, are also
   timed beside their parent commit's versions on the same inputs
   (``parent_ms``, ``PARENT_KERNELS``; the parent conv's all-ones border
   padded in the timed call, as its wrapper did), built into
   ``build/parent/`` from ``--parent-src DIR`` or ``git show HEAD~1`` (not
   measured without either). The three conv kernels are timed beside a
   bf16 ``F.conv2d`` of the same ±1 operands (``library_bf16_ms``, a
   timing yardstick only: its outputs round).
   Before them, the rates of the three inner loops a packed ±1
   product can run (``XNOR_LOOP_BODY``: popc on the CUDA cores, 1-bit and
   int8 ``mma.sync``) are measured and stored.
4. Serves 12 ragged requests (1-8 images) on the trained checkpoint
   ``tests/golden/bnn_trained_ckpt.npz`` through ``ServingEngine
   (engine="xnor")`` for each ``conv_impl``, and through
   ``ContinuousServingEngine(engine="megakernel")`` with a
   ``FallbackPolicy`` holding both param sets, and holds every request's
   logits, bit for bit, against the ``xla`` (plain-torch) forward of
   the same images on the card. The launch counters are reset just
   before each path's engine is built and read just after its drain:
   each path must have launched exactly its own kernels per forward
   (warmup and served batches: one per layer on the ``xnor`` paths,
   3 conv stages + 1 chain on the megakernel path), and no engine
   failover may be recorded. Times the batch-32 forward of each path.
5. Table 2 on the card: ``bnn_apply`` of the six presets of
   ``repro_torch.configs.bnn_cifar`` on the trained checkpoint at batch
   64. The launch counters are reset just before each preset's checked
   forward and read just after: each preset must launch exactly its
   kernels (PAPER_KERNEL 8 ``pack_rows`` + 8 ``xnor_gemm``,
   DIRECT_KERNEL 5 ``direct_conv`` + 3 + 3, MXU_KERNEL 8
   ``unpack_gemm``, the others none), and the output of each of those
   calls must equal its plain twin on the call's own inputs. A profiler
   failure leaves the breakdown "not measured"; a kernel or wrapper
   error fails the run. The four PACKED presets and
   SIMULATION must give logits bit-identical to the fused ``xla``
   forward of the same images on the card; CONTROL_GROUP (float
   layers, zero-padded borders: other logits) is held to its CPU
   forward on 4 of the images. Prints each preset's device (graph) and
   eager ms, weight bytes, and the CONTROL_GROUP / PAPER_KERNEL ratio.
6. Serves one full-width period of jamba-1.5-large-398b (8 of its 72
   layers; every width, all 16 experts, vocab 65536) from 1-bit packed
   weights through ``repro_torch.launch.serve.serve_config``: batch 4,
   a 512-token prompt, 8 greedy tokens (``jamba_phase``). The prefill
   must launch ``ssm_scan_chunk`` exactly 14 times (7 mamba layers x 2
   chunks) and nothing else, each decode step nothing; every scan call
   of the prefill is held within rtol/atol 1e-5 of its twin on its own
   inputs, and the logits of every step against the same model run
   with the twin in place of the kernel (``JAMBA_LOGIT_TOL``). Prints
   packed vs bf16 weight bytes, prefill and decode ms (CUDA events),
   peak memory and profiles. (Phase 3 also runs ``ssm_scan_chunk`` at
   the prefill's chunk, a short prompt's and a ragged case, within
   rtol/atol 1e-5 of its twin. It also runs ``flash_attention`` at
   smollm-360m's training shape [60, 4096, 64] in bf16, in float32 and at
   a ragged [3, 1000, 64], against its twin with the kernel's KV tile,
   with ``F.scaled_dot_product_attention`` as the yardstick, and
   ``mlstm_chunked`` at xlstm-1.3b's [8, 4096, 1024, 1024], chunk 256, and
   on one chunk (``attention_phase``).)
7. The LM training forward (``lm_phase``): ``Model.loss`` of smollm-360m
   (32 layers, batch 4 x 4096) and xlstm-1.3b (48 layers, batch 2 x 4096)
   at full width under ``train_policy()``, on random float32 params and a
   batch of ``synthetic_lm_batches``. The launch counts are reset just
   before each loss forward and read after it: 32 ``flash_attention`` /
   42 ``mlstm_chunked`` launches and nothing else; every kernel call of
   that forward is held against its twin on its own inputs; loss and
   logits are held to the same model with the twins in place of the
   kernels (``LM_CASES``, ``LM_LOSS_TOL``, ``LM_LOGIT_TOL``,
   ``LM_F32_LOSS_TOL``, ``LM_F32_LOGIT_TOL``). Prints the loss, the forward's ms (CUDA
   events), peak memory and a profile.

Last, prints a ``{"kernels": [...]}`` line, then ``{"ok": true, ...}``.

Exits non-zero, with no result line, when CUDA is unavailable or any
phase fails. Per-shape details go to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and int8
# tensor-core ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# The ±1 products of the xnor kernels (2 ops each). NVIDIA publishes no
# 1-bit rate; this script's ``xnor_loop_rates`` measures the 1-bit
# ``mma.sync`` m16n8k256 (and.popc) at the int8 m16n8k32's instruction
# rate, with 8x its products, so their peak is taken as 8x int8's.
B1_OPS_PER_S = 8 * INT8_OPS_PER_S
# Float32 on the CUDA cores (pack_rows' compares), bf16 on the tensor
# cores (unpack_gemm: its ±1 operands are exact in bf16) and tf32 on the
# tensor cores (the mLSTM's 3xTF32 products, ``tc_bound_ms``), dense.
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
# The scan's exps run on the special-function units: 16 MUFU.EX2 per clock
# per SM (CUDA C++ programming guide, arithmetic instruction throughput,
# compute capability 9.0), 132 SMs, at the 1.98 GHz boost clock.
MUFU_EX2_PER_S = 132 * 16 * 1.98e9
OPS_RATE = {"pack_rows": FP32_OPS_PER_S, "unpack_gemm": BF16_OPS_PER_S,
            "ssm_scan_chunk": MUFU_EX2_PER_S,
            "flash_attention": BF16_OPS_PER_S, "mlstm_chunked": FP32_OPS_PER_S}
# Read between calls to time a kernel with a cold L2 (50 MB on the H100).
L2_FLUSH_BYTES = 128 * 2**20
BATCH = 32
CKPT = ROOT / "tests" / "golden" / "bnn_trained_ckpt.npz"
OUT_DIR = ROOT / "build"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, iters: int = 20, reps: int = 5, cold: bool = False) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events (median), so no host
    dispatch gap between launches is counted. ``cold``: each call follows
    a read of 128 MB (past the 50 MB L2), so its operands come from HBM,
    as its bytes bound assumes; the time of the reads alone, captured
    the same way, is subtracted."""
    if cold:
        flush_buf = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
        flush = flush_buf.sum

        def flushed():
            flush()
            fn()

        return graph_ms(flushed, iters, reps) - graph_ms(flush, iters, reps)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int,
             rate: float = B1_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rand_words(gen: torch.Generator, shape, dev) -> torch.Tensor:
    w = torch.randint(0, 2**32, shape, generator=gen, dtype=torch.int64)
    return (w - ((w >> 31) << 32)).to(torch.int32).to(dev)


def rand_affine(gen: torch.Generator, m: int, k_bits: int, dev):
    """Per-row (a, b) whose sign threshold lands inside the dot's spread,
    so the packed outputs carry both bit values."""
    sign = torch.where(torch.rand(m, generator=gen) < 0.5, -1.0, 1.0)
    a = (0.5 + torch.rand(m, generator=gen)) * sign
    b = torch.randn(m, generator=gen) * (k_bits ** 0.5) * a.abs()
    return a.float().to(dev), b.float().to(dev)


def gemm_cases():
    """(label, M, KW, N, k_bits) of every GEMM the batch-32 forward runs:
    the head, fc0, fc1 and (conv_impl="im2col") the five binary convs."""
    n_img = BATCH
    fused = [("fc0", 1024, 256, n_img, 8192), ("fc1", 1024, 32, n_img, 1024)]
    for i, (h, cin, cout) in enumerate(
            [(32, 128, 128), (16, 128, 256), (16, 256, 256), (8, 256, 512),
             (8, 512, 512)], start=1):
        fused.append((f"conv{i}/im2col", cout, 9 * cin // 32, n_img * h * h,
                      9 * cin))
    return [("head", 10, 32, n_img, 1024)], fused


def conv_cases():
    """(label, H, C, D) of every direct conv of the batch-32 forward."""
    return [("conv1", 32, 128, 128), ("conv2", 16, 128, 256),
            ("conv3", 16, 256, 256), ("conv4", 8, 256, 512),
            ("conv5", 8, 512, 512)]


def check_equal(name: str, label: str, got: torch.Tensor,
                want: torch.Tensor) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name} {label}: {tuple(got.shape)}/{got.dtype} vs twin "
             f"{tuple(want.shape)}/{want.dtype}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
    if err != 0:
        bad = int((got != want).sum().item())
        fail(f"{name} {label}: {bad} words differ from the plain twin "
             f"(max abs err {err})")
    return err


# The kernels this commit redesigned, timed beside their parent commit's
# versions in the same run (``--parent-src``, else ``git show HEAD~1``).
# {kernel: (its source, the parent's C launcher, its argtypes as the
# parent's build.py declared them)}: the direct conv's int32 dot (x padded,
# w, out, N, Hp, Wp, CW, D, kh, kw, stride, k_bits, stream) and the scan
# (dt, xh, B, C, A, h0, y, h_out, batch, chunk, di, ds, the batch and time
# strides of dt, xh, B and C, stream).
PARENT_KERNELS = {
    "direct_conv": ("direct_conv", "repro_direct_conv_dot",
                    (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)),
    "ssm_scan_chunk": ("ssm_scan", "repro_ssm_scan_chunk",
                       (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 4
                       + (ctypes.c_longlong,) * 8 + (ctypes.c_void_p,)),
}
PARENT_SOURCES = sorted({source for source, _, _ in PARENT_KERNELS.values()})
PARENT_DIR = OUT_DIR / "parent"


def start_parent_build(parent_src: str | None):
    """Fetch the parent's sources of ``PARENT_KERNELS`` and the headers
    they include (from the directory ``parent_src``, else from git's
    ``HEAD~1``) into ``build/parent/`` and start one ``nvcc`` per source,
    beside the main build. Returns ``{source: Popen}``, or a reason string
    where there is no parent source."""
    from repro_torch.kernels import build

    def fetch(fname: str) -> str | None:
        if parent_src is not None:
            path = pathlib.Path(parent_src) / fname
            return path.read_text() if path.is_file() else None
        got = subprocess.run(
            ["git", "-C", str(ROOT), "show",
             f"HEAD~1:src/repro_torch/kernels/csrc/{fname}"],
            capture_output=True, text=True)
        return got.stdout if got.returncode == 0 else None

    PARENT_DIR.mkdir(parents=True, exist_ok=True)
    procs, headers = {}, set()
    for name in PARENT_SOURCES:
        text = fetch(f"{name}.cu")
        if text is None:
            return (f"no parent {name}.cu (from --parent-src or git show "
                    "HEAD~1)")
        # The parent's launchers must still take the arguments listed above.
        for source, symbol, argtypes in PARENT_KERNELS.values():
            if source != name:
                continue
            decl = text[text.find(f'extern "C" int {symbol}('):]
            decl = decl[:decl.find(")")]
            if not decl or decl.count(",") + 1 != len(argtypes):
                return f"the parent's {symbol} takes other arguments"
        (PARENT_DIR / f"{name}.cu").write_text(text)
        pending = [text]
        while pending:  # the headers it includes, and theirs
            for header in re.findall(r'#include "([^"]+)"', pending.pop()):
                if header not in headers:
                    headers.add(header)
                    body = fetch(header)
                    if body is None:
                        return f"no parent {header}"
                    (PARENT_DIR / header).write_text(body)
                    pending.append(body)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(PARENT_DIR / f"{name}.so"),
             str(PARENT_DIR / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    return procs


def finish_parent_build(procs) -> dict | str:
    """``{kernel: launcher}`` of the parent's kernels (argtypes set), or
    the reason they are not measured."""
    if isinstance(procs, str):
        return procs
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            return f"the parent's {name}.cu did not build:\n{log[-2000:]}"
    launchers = {}
    for kernel, (source, symbol, argtypes) in PARENT_KERNELS.items():
        fn = getattr(ctypes.CDLL(str(PARENT_DIR / f"{source}.so")), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        launchers[kernel] = fn
    return launchers


# The three inner loops a packed ±1 product can run on this card, each in
# registers (no loads), many independent accumulators a warp, so each runs
# at its instruction's issue ceiling: (a) xnor + popc + add on the CUDA
# cores (fused_gemm.cu before its tensor-core tile), (b) the 1-bit
# tensor-core product mma.sync m16n8k256 with and.popc or xor.popc, (c)
# int8 mma.sync m16n8k32 (on ±1 bytes: exact). Rates are bit products a
# second (one ±1 multiply-add each). Each variant is its own source, so
# one that ptxas refuses does not stop the others. {variant: (bit products
# a thread-iteration, loop body)}.
XNOR_LOOP_BODY = {
    "popc": (32 * 8, r"""
  unsigned acc[8] = {};
  unsigned x[8];
  for (int j = 0; j < 8; ++j) x[j] = seed * (2 * j + 3);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // the word pair varies with the running count, so nothing of the
      // xnor and popc is loop-invariant
      asm volatile("{\n .reg .b32 t;\n xor.b32 t, %0, %1;\n not.b32 t, t;\n"
                   " popc.b32 t, t;\n add.u32 %0, %0, t;\n}\n"
                   : "+r"(acc[j]) : "r"(x[j]));
    }
  }
  unsigned s = 0;
  for (int j = 0; j < 8; ++j) s += acc[j];"""),
    **{f"b1 {op}": (16 * 8 * 256 * 8 // 32, r"""
  int c[8][4] = {};
  const unsigned a0 = seed, a1 = seed * 3, a2 = seed * 5, a3 = seed * 7;
  const unsigned b0 = seed ^ 0x5555u, b1 = seed ^ 0xa5a5u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      asm volatile(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.OP {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(c[i][0]), "+r"(c[i][1]), "+r"(c[i][2]), "+r"(c[i][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  unsigned s = 0;
  for (int i = 0; i < 8; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];""".replace(
        "OP", op)) for op in ("and.popc", "xor.popc")},
    "int8": (16 * 8 * 32 * 8 // 32, r"""
  int c[8][4] = {};
  const unsigned a0 = seed, a1 = seed * 3, a2 = seed * 5, a3 = seed * 7;
  const unsigned b0 = seed ^ 0x5555u, b1 = seed ^ 0xa5a5u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(c[i][0]), "+r"(c[i][1]), "+r"(c[i][2]), "+r"(c[i][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  unsigned s = 0;
  for (int i = 0; i < 8; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];"""),
}
XNOR_LOOP_DIR = OUT_DIR / "xnor_loops"


def start_xnor_loop_build() -> dict:
    """One ``nvcc`` per inner loop of ``XNOR_LOOP_BODY``, started beside the
    main build: ``{variant: (so path, Popen)}``."""
    from repro_torch.kernels import build

    procs = {}
    for i, (variant, (_, body)) in enumerate(XNOR_LOOP_BODY.items()):
        d = XNOR_LOOP_DIR / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "loop.cu").write_text(
            "#include <cuda_runtime.h>\n"
            "__global__ void loop(unsigned* out, int iters) {\n"
            "  const unsigned seed = threadIdx.x * 2654435761u + blockIdx.x;\n"
            + body + "\n  out[blockIdx.x * blockDim.x + threadIdx.x] = s;\n}\n"
            'extern "C" int run_loop(unsigned* out, int blocks, int threads, '
            "int iters) {\n  loop<<<blocks, threads>>>(out, iters);\n"
            "  return static_cast<int>(cudaGetLastError());\n}\n")
        procs[variant] = (d / "loop.so", subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / "loop.so"),
             str(d / "loop.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def xnor_loop_rates(procs: dict) -> dict:
    """Bit products a second of each inner loop at full occupancy (2 blocks
    of 256 threads an SM, CUDA events); a variant ptxas refuses is
    reported with the compiler's words. Also prints each rate."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 2 * sms, 256, 4096
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    rates = {}
    for variant, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            rates[variant] = {"error": log.strip()[-600:]}
            print(f"  inner loop {variant}: not built ({log.strip()[-200:]})",
                  flush=True)
            continue
        lib = ctypes.CDLL(str(so))
        lib.run_loop.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
        run = lambda: lib.run_loop(out.data_ptr(), blocks, threads, iters)  # noqa: E731,B023
        if run():
            fail(f"inner loop {variant} did not launch")
        ms = time_ms(run, iters=3)
        bits = blocks * threads * iters * XNOR_LOOP_BODY[variant][0]
        rates[variant] = {"ms": ms, "bit_products_per_s": bits / ms * 1e3}
        print(f"  inner loop {variant:12s}: {bits / ms / 1e9:10.1f} T bit "
              f"products/s ({2 * bits / ms / 1e9:.1f} TOP/s at 2 ops each; "
              f"{blocks} blocks x {threads} threads, {ms:.3f} ms)", flush=True)
    return rates


def parent_direct_conv_dot(fn, w, x, k_bits):
    """The parent's direct conv dot (3x3, stride 1, pad 1) on (w, x), the
    all-ones border padded here as the parent's wrapper did (timed with
    the call): a callable for ``record``."""
    n, h, wd, cw = x.shape
    d = w.shape[0]
    out = torch.empty((n, h, wd, d), dtype=torch.int32, device=w.device)

    def run():
        xpad = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1), value=-1)
        rc = fn(xpad.data_ptr(), w.data_ptr(), out.data_ptr(), n, h + 2, wd + 2,
                cw, d, 3, 3, 1, k_bits, torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"parent direct_conv launch failed: CUDA error {rc}")
        return out
    return run


def parent_scan(fn, dt, xh, bm, cm, a, h0):
    """The parent's scan on the wrapper's operands (read in place through
    the same strides): a callable for ``record``."""
    b, c, di = dt.shape
    ds = a.shape[1]
    y = torch.empty((b, c, di), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((b, di, ds), dtype=torch.float32, device=dt.device)

    def run():
        rc = fn(dt.data_ptr(), xh.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                b, c, di, ds, dt.stride(0), dt.stride(1), xh.stride(0),
                xh.stride(1), bm.stride(0), bm.stride(1), cm.stride(0),
                cm.stride(1), torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"parent ssm_scan_chunk launch failed: CUDA error {rc}")
        return y, h_last
    return run


def kernel_phase(dev) -> tuple[dict, list]:
    from repro_torch.core import bitops
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(0)
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "library_ms": 0.0, "max_abs_err": 0, "bytes": 0, "ops": 0}
              for k in ops.LAUNCHES}
    rows = []
    head, fused = gemm_cases()
    for name, cases in (("xnor_gemm", head), ("fused_xnor_gemm", fused)):
        for label, m, kw, n, k_bits in cases:
            w = rand_words(gen, (m, kw), dev)
            x = rand_words(gen, (kw, n), dev)
            if name == "xnor_gemm":
                a = b = None
                run = lambda: ops.xnor_gemm(w, x, k_bits)  # noqa: E731
                twin = lambda: bitops.xnor_popcount_matmul(w, x, k_bits)  # noqa: E731
                out_bytes = m * n * 4
            else:
                a, b = rand_affine(gen, m, k_bits, dev)
                run = lambda: ops.fused_xnor_gemm(w, x, k_bits, a, b)  # noqa: E731
                twin = lambda: bitops.fused_xnor_layer(w, x, k_bits, a, b)  # noqa: E731
                out_bytes = -(-m // 32) * n * 4
            err = check_equal(name, label, run(), twin())
            # Yardstick: the same ±1 dot as an fp32 matmul (K words past
            # k_bits are xnor-neutral pads, none here: k_bits = 32*KW).
            wf = bitops.unpack_bits(w, axis=-1)
            xf = bitops.unpack_bits(x, axis=0)
            lib = lambda: torch.matmul(wf, xf)  # noqa: E731
            nbytes = (w.numel() + x.numel()) * 4 + out_bytes
            nbytes += 0 if a is None else 8 * m
            ops_n = 2 * m * n * k_bits
            rows.append(record(totals[name], name, label, err, run, twin, lib,
                               nbytes, ops_n))
    for label, h, c, d in conv_cases():
        cw, k_bits = c // 32, 9 * c
        x = rand_words(gen, (BATCH, h, h, cw), dev)
        w = rand_words(gen, (d, 9 * cw), dev)
        a, b = rand_affine(gen, d, k_bits, dev)
        run = lambda: ops.fused_direct_conv(  # noqa: E731
            w, x, k_bits, a, b, kh=3, kw=3, stride=1, pad=1)
        twin = lambda: bitops.direct_conv_oracle(  # noqa: E731
            w, x, k_bits, a, b, kh=3, kw=3, stride=1, pad=1)
        want = twin()
        err = check_equal("fused_direct_conv", label, run(), want)
        # Yardstick: F.conv2d of the ±1 map, pre-padded with +1 (the
        # binary border), and the ±1 filters, NCHW, TF32 off; and the same
        # in bf16 (a timing yardstick only: its outputs round).
        xf = torch.nn.functional.pad(
            bitops.unpack_bits(x, axis=-1).permute(0, 3, 1, 2), (1, 1, 1, 1),
            value=1.0).contiguous()
        wf = bitops.unpack_bits(w, axis=-1).reshape(d, 3, 3, c).permute(
            0, 3, 1, 2).contiguous()
        lib = lambda: torch.nn.functional.conv2d(xf, wf)  # noqa: E731
        xh, wh = xf.bfloat16(), wf.bfloat16()
        lib_bf16 = lambda: torch.nn.functional.conv2d(xh, wh)  # noqa: E731
        nbytes = (x.numel() + w.numel() + BATCH * h * h * (d // 32)) * 4 + 8 * d
        ops_n = 2 * BATCH * h * h * d * k_bits
        rows.append(record(totals["fused_direct_conv"], "fused_direct_conv",
                           label, err, run, twin, lib, nbytes, ops_n,
                           lib_bf16=lib_bf16))
    return totals, rows


def record(total: dict, name: str, label: str, err, run, twin, lib,
           nbytes: int, ops_n: int, per_layer=None, summed: bool = True,
           plain_reps: int = 3, cold: bool = False,
           check: str = "exact", rate: float | None = None,
           parent=None, lib_bf16=None) -> dict:
    """Time one main-path shape: kernel (graph replay and eager call),
    twin, library yardstick (``lib``; None where no single PyTorch call
    computes the function), for a megakernel the slice-1 per-layer
    kernels over the same layers (``per_layer``), and for a redesigned
    kernel the parent commit's version on the same inputs (``parent``,
    see ``parent_kernels``). The kernel's totals sum the times of its
    main path's shapes only (``summed``); every shape's error counts.
    ``cold``: the kernel's time is taken with a cold L2 (its warm time is
    kept as ``warm_ms``). ``lib_bf16``: the library yardstick in bf16 (a
    timing yardstick only; its outputs round), kept as
    ``library_bf16_ms``. ``check`` says how the shape was held to its
    twin; ``rate`` replaces the kernel's peak rate in the bound (a
    float32 case of a bf16 kernel)."""
    ms = graph_ms(run, cold=cold)
    eager_ms = time_ms(run, iters=50)
    plain_ms = time_ms(twin, iters=2, reps=plain_reps)
    library_ms = graph_ms(lib, iters=5) if lib is not None else None
    bms, by = bound_ms(nbytes, ops_n,
                       rate or OPS_RATE.get(name, B1_OPS_PER_S))
    row = {"kernel": name, "shape": label, "max_abs_err": err, "ms": ms,
           "eager_ms": eager_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
           "bytes": nbytes, "ops": ops_n}
    if cold:
        row["warm_ms"] = graph_ms(run)
    lib_txt = "none" if library_ms is None else f"{library_ms:.4f} ms"
    line = (f"  {name:21s} {label:18s} {check}  kernel {ms:.4f} ms"
            + (f" cold L2, {row['warm_ms']:.4f} warm" if cold else "")
            + f" (eager call {eager_ms:.4f})  plain {plain_ms:.3f} ms  library "
            f"{lib_txt}  bound {bms:.5f} ms ({by})")
    if per_layer is not None:
        row["per_layer_ms"] = graph_ms(per_layer)
        line += f"  per-layer kernels {row['per_layer_ms']:.4f} ms"
    if parent is not None:
        row["parent_ms"] = graph_ms(parent)
        line += f"  parent {row['parent_ms']:.4f} ms"
    if lib_bf16 is not None:
        row["library_bf16_ms"] = graph_ms(lib_bf16, iters=5)
        line += f"  library bf16 {row['library_bf16_ms']:.4f} ms"
    print(line, flush=True)
    total["max_abs_err"] = max(total["max_abs_err"], err)
    if not summed:
        return row
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "per_layer_ms",
              "parent_ms", "library_bf16_ms"):
        if k in row:
            total[k] = None if row[k] is None else total.get(k, 0.0) + row[k]
    total["bytes"] += nbytes
    total["ops"] += ops_n
    return row


# (label, input H, channels of each conv) of the three conv stages.
STAGE_CASES = [("stage1/conv1", 32, (128, 128)),
               ("stage2/conv2+3", 16, (128, 256, 256)),
               ("stage3/conv4+5", 8, (256, 512, 512))]


def stage_operands(gen, h, chans, n, dev):
    x = rand_words(gen, (n, h, h, chans[0] // 32), dev)
    ws, aff, k_bits = [], [], []
    for cin, cout in zip(chans[:-1], chans[1:]):
        ws.append(rand_words(gen, (cout, 9 * cin // 32), dev))
        aff.append(rand_affine(gen, cout, 9 * cin, dev))
        k_bits.append(9 * cin)
    return x, ws, [p[0] for p in aff], [p[1] for p in aff], k_bits


def megakernel_phase(dev, totals: dict, rows: list) -> None:
    """Both megakernels at the main path's shapes, bit-exact against their
    twins, timed beside the per-layer kernels and a library chain (fp32,
    and bf16 for the conv stages)."""
    from repro_torch.core import bitops
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(1)
    F = torch.nn.functional
    for label, h, chans in STAGE_CASES:
        for n in (3, BATCH):
            x, ws, a, b, k_bits = stage_operands(gen, h, chans, n, dev)
            run = lambda: ops.megakernel_conv_stage(x, ws, a, b, k_bits)  # noqa: E731,B023
            twin = lambda: bitops.conv_stage_xla(x, ws, a, b, k_bits)  # noqa: E731,B023
            want = twin()
            err = check_equal("megakernel_conv_stage", f"{label} b{n}", run(),
                              want)
            if n != BATCH:
                print(f"  megakernel_conv_stage {label} batch {n}: exact",
                      flush=True)
                continue

            def per_layer(x=x, ws=ws, a=a, b=b, k_bits=k_bits):
                y = x
                for wl, al, bl, k in zip(ws, a, b, k_bits):
                    y = ops.fused_direct_conv(wl, y, k, al, bl, kh=3, kw=3,
                                              stride=1, pad=1)
                return bitops.maxpool2_packed(y)

            # Yardstick: F.conv2d of the ±1 map and filters (zero padding),
            # sign between convs, max_pool2d, NCHW, TF32 off.
            xf = bitops.unpack_bits(x, axis=-1).permute(0, 3, 1, 2).contiguous()
            wfs = [bitops.unpack_bits(wl, axis=-1).reshape(
                wl.shape[0], 3, 3, -1).permute(0, 3, 1, 2).contiguous()
                for wl in ws]

            def lib(xf=xf, wfs=wfs):
                y = xf
                for i, wf in enumerate(wfs):
                    y = F.conv2d(y if i == 0 else y.sign(), wf, padding=1)
                return F.max_pool2d(y, 2)

            xh, whs = xf.bfloat16(), [wf.bfloat16() for wf in wfs]

            out_words = n * (h // 2) ** 2 * chans[-1] // 32
            nbytes = (x.numel() + sum(wl.numel() for wl in ws) + out_words) * 4
            nbytes += 8 * sum(chans[1:])
            ops_n = 2 * n * h * h * sum(d * k for d, k in zip(chans[1:], k_bits))
            row = record(totals["megakernel_conv_stage"], "megakernel_conv_stage",
                         label, err, run, twin, lib, nbytes, ops_n,
                         per_layer=per_layer,
                         lib_bf16=lambda xh=xh, whs=whs: lib(xh, whs))
            # the launcher's occupancy query: shared memory of a CTA and the
            # clusters the card holds at once (the batch's 32 in one wave?)
            d_words = tuple(wl.shape[0] // 32 for wl in ws)
            row["smem_bytes"], row["clusters_at_once"] = next(
                (v for k, v in ops._LIMITS.items()
                 if k[0] == "megakernel_conv_stage" and k[2][0] == d_words),
                ("not measured", "not measured"))
            print(f"    {row['smem_bytes']} B of shared memory a CTA, "
                  f"{row['clusters_at_once']} clusters of {ops.MAX_CLUSTER} at once",
                  flush=True)
            rows.append(row)

    # The FC trunk: fc0 [1024, 8192] + fc1 [1024, 1024] stacked, head
    # [10, 1024]. Batch 32 as served (masked-tail path), then tails.
    w_stack = rand_words(gen, (2, 1024, 256), dev)
    w_stack[1, :, 32:] = 0                   # fc1's K pad words
    aff = [rand_affine(gen, 1024, k, dev) for k in (8192, 1024)]
    a_stack = torch.stack([p[0] for p in aff])
    b_stack = torch.stack([p[1] for p in aff])
    fin = rand_words(gen, (10, 32), dev)
    k_bits = (8192, 1024)
    w0, w1 = w_stack[0].contiguous(), w_stack[1, :, :32].contiguous()
    fc_words = (w0.numel() + w1.numel() + fin.numel()) * 4 + a_stack.numel() * 8
    for n, n_real in ((BATCH, BATCH), (8, 1), (8, 3), (16, 13)):
        x = rand_words(gen, (256, n), dev)
        run = lambda: ops.megakernel_chain(  # noqa: E731
            w_stack, a_stack, b_stack, k_bits, x, 1024, final_wp=fin,  # noqa: B023
            final_k_bits=1024, ragged_tile=ops.RAGGED_TILE_N, n_real=n_real)  # noqa: B023
        twin = lambda: bitops.megakernel_chain_ragged_xla(  # noqa: E731
            w_stack, a_stack, b_stack, k_bits, x, 1024, n_real,  # noqa: B023
            final_wp=fin, final_k_bits=1024)
        label = f"fc trunk b{n}" + (f" n_real {n_real}" if n_real != n else "")
        got = run()
        err = check_equal("megakernel_chain", label, got, twin())
        if got[:, n_real:].any():
            fail(f"megakernel_chain {label}: pad columns not zeroed")

        def per_layer(x=x):
            y = ops.fused_xnor_gemm(w0, x, 8192, a_stack[0], b_stack[0])
            # (no-op on the card, whose kernel outputs are contiguous)
            y = ops.fused_xnor_gemm(w1, y.contiguous(), 1024, a_stack[1],
                                    b_stack[1])
            return ops.xnor_gemm(fin, y.contiguous(), 1024)

        wf = [bitops.unpack_bits(w, axis=-1) for w in (w0, w1, fin)]
        xf = bitops.unpack_bits(x, axis=0)

        def lib(wf=wf, xf=xf):
            y = torch.matmul(wf[0], xf).sign()
            return torch.matmul(wf[2], torch.matmul(wf[1], y).sign())

        nbytes = fc_words + (x.numel() + 10 * n) * 4
        ops_n = 2 * n * (1024 * 8192 + 1024 * 1024 + 10 * 1024)
        rows.append(record(totals["megakernel_chain"], "megakernel_chain", label,
                           err, run, twin, lib, nbytes, ops_n,
                           per_layer=per_layer, summed=n == n_real == BATCH))


# (label, batch, chunk, d_inner, d_state, sequence the chunk is a view
# of) of the scan: the served prefill's second chunk of a 512-token
# prompt, a short prompt's only chunk, and a ragged case.
SCAN_CASES = [("prefill chunk", 4, 256, 16384, 16, 512),
              ("short prompt", 4, 32, 16384, 16, 32),
              ("ragged", 3, 37, 16384 + 96, 16, 37)]
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
# jamba's dt rank, ceil(d_model / 16): B and C sit after it in x_proj's output.
JAMBA_DT_RANK = 512


def scan_error(name: str, label: str, got, want) -> float:
    """Max abs error of (y, h_last) against the twin's; fails outside
    ``SCAN_TOL`` (y sums over the state in another order)."""
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{name} {label}: {tuple(g.shape)} vs twin {tuple(w.shape)}, "
                 f"finite={bool(torch.isfinite(g).all())}")
        diff = (g - w).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        bad = int((diff > SCAN_TOL["atol"] + SCAN_TOL["rtol"] * w.abs()).sum())
        if bad:
            fail(f"{name} {label}: {bad} outputs outside rtol/atol 1e-5 of the "
                 f"plain twin (max abs err {err:.3g})")
    return err


def scan_operands(gen, b, c, di, ds, seq, dev):
    """The scan's operands as the mamba prefill hands them over: dt and x
    chunk views of ``[b, seq, di]`` tensors (the last chunk), B and C
    column slices of an x_proj output ``[b, seq, r + 2*ds]``, A of the
    model's init (-1..-ds), h0 != 0 (a carried state)."""
    sl = slice(seq - c, seq)
    dt = torch.nn.functional.softplus(
        torch.randn((b, seq, di), generator=gen, device=dev))[:, sl]
    xh = torch.randn((b, seq, di), generator=gen, device=dev)[:, sl]
    bc = torch.randn((b, seq, JAMBA_DT_RANK + 2 * ds), generator=gen,
                     device=dev)[:, sl]
    bm, cm = bc[..., JAMBA_DT_RANK:JAMBA_DT_RANK + ds], bc[..., JAMBA_DT_RANK + ds:]
    a = -torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(
        di, ds).contiguous()
    h0 = torch.randn((b, di, ds), generator=gen, device=dev) * 0.1
    return dt, xh, bm, cm, a, h0


def scan_phase(dev, totals: dict, rows: list, parents=None) -> None:
    """``ssm_scan_chunk`` at the served prefill's chunk (its time makes the
    kernels-line total), a short prompt's chunk and a ragged case, held
    within rtol/atol 1e-5 of its twin on the card, and timed beside the
    parent commit's kernel (``parents``, held to the twin too). Bound: the
    larger of the bytes over HBM and the exps over the MUFU rate; the FP32
    issue bound (6 operations per exp plus dt*x) is kept beside it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssm_scan_chunk_ref

    gen = torch.Generator(device=dev).manual_seed(14)
    for label, b, c, di, ds, seq in SCAN_CASES:
        args = scan_operands(gen, b, c, di, ds, seq, dev)
        run = lambda: ops.ssm_scan_chunk(*args)  # noqa: E731,B023
        twin = lambda: ssm_scan_chunk_ref(*args)  # noqa: E731,B023
        want = twin()
        err = scan_error("ssm_scan_chunk", label, run(), want)
        parent = None
        if isinstance(parents, dict):
            parent = parent_scan(parents["ssm_scan_chunk"], *args)
            scan_error("parent ssm_scan_chunk", label, parent(), want)
        exps = b * c * di * ds
        nbytes = (3 * b * c * di + 2 * b * di * ds + di * ds + 2 * b * c * ds) * 4
        row = record(totals["ssm_scan_chunk"], "ssm_scan_chunk",
                     f"{label} [{b},{c},{di},{ds}]", err, run, twin, None,
                     nbytes, exps, summed=label == "prefill chunk",
                     check=f"max err {err:.2g}", parent=parent)
        if parent is not None:
            # the same float operations in the same order as the parent's
            # one thread a channel: expected bit for bit
            row["equals_parent"] = all(torch.equal(g, w) for g, w in zip(run(), parent()))
            print(f"    bit-identical to the parent kernel: {row['equals_parent']}",
                  flush=True)
        row["fp32_bound_ms"] = (6 * exps + b * c * di) / FP32_OPS_PER_S * 1e3
        if label == "prefill chunk":
            totals["ssm_scan_chunk"]["fp32_bound_ms"] = row["fp32_bound_ms"]
        rows.append(row)


# (label, BH, S, Dh, dtype) of flash attention: smollm-360m's training
# forward (batch 4 x 15 heads, S 4096; its time makes the kernels-line
# total), the same in float32, and a ragged case (odd BH, S not a
# multiple of the bf16 kernel's 128-row block).
FLASH_CASES = [("smollm layer", 60, 4096, 64, torch.bfloat16),
               ("float32", 60, 4096, 64, torch.float32),
               ("ragged", 3, 1000, 64, torch.bfloat16)]
# Float32: rtol/atol 1e-5 (dot products and sums in other orders). Bf16:
# one bf16 ulp of the largest output of the row, each output within
# FLASH_ELEM_ULPS bf16 ulps of its own and at most FLASH_PAST_SHARE of
# the outputs past one (see flash_error). The last two are set from the
# readings on an H100 (at most 13 own ulps, at most 6.1e-5 of a call's
# outputs past one, on random inputs and on smollm-360m's own), with
# room: a kernel that moved small outputs within their row's ulp would
# move far more than 0.1% of them.
FLASH_F32_TOL = dict(rtol=1e-5, atol=1e-5)
FLASH_ELEM_ULPS = 32.0
FLASH_PAST_SHARE = 1e-3
# (label, BH, S, dk, dv, chunk) of the mLSTM: xlstm-1.3b's training
# forward (batch 2 x 4 heads, 16 chunks of 256; its time makes the
# total) and a one-chunk sequence.
MLSTM_CASES = [("xlstm layer", 8, 4096, 1024, 1024, 256),
               ("one chunk", 8, 256, 1024, 1024, 256)]
# y, C, n: float32 sums over dk and the chunk in other orders. m: the same
# float operations in the same order as the twin, so equal.
MLSTM_TOL = dict(rtol=1e-4, atol=1e-4)


def bf16_ulp(x: torch.Tensor, floor: float = 2.0**-8) -> torch.Tensor:
    """One bfloat16 ulp at the magnitude of ``x`` (float32), taken at
    ``floor`` below it."""
    _, exp = torch.frexp(torch.clamp(x.abs(), min=floor))
    return torch.ldexp(torch.ones_like(x), exp - 8)


def flash_error(label: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """Flash attention against its twin with the kernel's KV tile (which
    rounds where the kernel rounds). Float32: within ``FLASH_F32_TOL``.
    Bf16: within one bf16 ulp of the largest output of each row: the
    tensor cores sum q . k in another order than cuBLAS, and where a
    score moves by a float32 ulp p's rounding to bf16 can flip, which
    moves the row by up to 2^-8 p_j |v_j| / l, a step at the scale of the
    row's values. Each output is also held within ``FLASH_ELEM_ULPS``
    bf16 ulps of its own (taken at 2^-8 below it, as ``bf16_ulp`` does),
    and at most ``FLASH_PAST_SHARE`` of the outputs may be past one."""
    if got.shape != want.shape or got.dtype != want.dtype or \
            not torch.isfinite(got).all():
        fail(f"flash_attention {label}: {tuple(got.shape)}/{got.dtype} vs twin "
             f"{tuple(want.shape)}/{want.dtype}, finite="
             f"{bool(torch.isfinite(got).all())}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    out = {"max_abs_err": float(diff.max())}
    if got.dtype == torch.float32:
        bad = int((diff > FLASH_F32_TOL["atol"] + FLASH_F32_TOL["rtol"] * w.abs()).sum())
        what = "rtol/atol 1e-5"
    else:
        row_ulps = diff / bf16_ulp(w.abs().amax(-1, keepdim=True))
        elem_ulps = diff / bf16_ulp(w)
        past = int((elem_ulps > 1).sum())
        out.update(max_row_ulps=float(row_ulps.max()),
                   max_elem_ulps=float(elem_ulps.max()),
                   elements_past_own_ulp=past, elements=diff.numel())
        bad = int((row_ulps > 1).sum()) + int((elem_ulps > FLASH_ELEM_ULPS).sum())
        what = (f"one bf16 ulp of their row's largest output or "
                f"{FLASH_ELEM_ULPS:g} of their own (max {out['max_elem_ulps']:.3g})")
        if past > FLASH_PAST_SHARE * diff.numel():
            fail(f"flash_attention {label}: {past} of {diff.numel()} outputs past "
                 f"one bf16 ulp of their own, more than {FLASH_PAST_SHARE:g}")
    if bad:
        fail(f"flash_attention {label}: {bad} outputs outside {what} of the "
             f"plain twin (max abs err {out['max_abs_err']:.3g})")
    return out


def mlstm_error(label: str, got, want) -> dict:
    """Max abs error of each of (y, C, n) against the twin's, and its
    largest share of the limit, within ``MLSTM_TOL``; m equal."""
    err = {}
    for name, g, w in zip(("y", "C", "n"), got[:3], want[:3]):
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"mlstm_chunked {label}: {name} {tuple(g.shape)} vs twin "
                 f"{tuple(w.shape)}, finite={bool(torch.isfinite(g).all())}")
        diff = (g - w).abs()
        limit = MLSTM_TOL["atol"] + MLSTM_TOL["rtol"] * w.abs()
        err[name] = float(diff.max())
        err[f"{name}_of_limit"] = float((diff / limit).max())
        bad = int((diff > limit).sum())
        if bad:
            fail(f"mlstm_chunked {label}: {bad} of {name} outside rtol/atol 1e-4 "
                 f"of the plain twin (max abs err {float(diff.max()):.3g})")
    if not torch.equal(got[3], want[3]):
        fail(f"mlstm_chunked {label}: m differs from the twin's (max abs "
             f"{float((got[3] - want[3]).abs().max()):.3g})")
    err["max_abs_err"] = max(err["y"], err["C"], err["n"])
    err["max_of_limit"] = max(err["y_of_limit"], err["C_of_limit"], err["n_of_limit"])
    return err


def flash_twin(q, k, v, causal=True):
    """The flash twin with the kernel's KV tile."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref

    return flash_attention_ref(q, k, v, causal=causal, block_kv=ops.FLASH_TILE)


def attention_phase(dev, totals: dict, rows: list) -> None:
    """``flash_attention`` at smollm-360m's training shape (bf16; its time
    makes the kernels-line total), in float32 and at a ragged shape, and
    ``mlstm_chunked`` at xlstm-1.3b's (its time makes the total) and on a
    one-chunk sequence, each held to its twin on the card and timed.
    Library yardstick of flash: ``F.scaled_dot_product_attention(...,
    is_causal=True)`` on the same tensors; none for the mLSTM. Bounds:
    flash 2 BH S^2 Dh operations (causal) at the bf16 tensor-core rate
    (float32 case: the CUDA cores' float32 rate) against Q, K, V and O;
    the mLSTM L (L + 1) (dk + dv) + 4 L dk dv per (bh, chunk) (the
    causal half of q k^T and of the weights times v, the diagonal
    included, then q C and the update of C) at the float32 rate against
    its operands."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import mlstm_chunked_ref

    gen = torch.Generator(device=dev).manual_seed(15)
    F = torch.nn.functional
    for label, bh, s, dh, dtype in FLASH_CASES:
        q, k, v = (torch.randn((bh, s, dh), generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        run = lambda: ops.flash_attention(q, k, v)  # noqa: E731,B023
        twin = lambda: flash_twin(q, k, v)  # noqa: E731,B023
        q4, k4, v4 = q[None], k[None], v[None]     # [1, BH, S, Dh]: SDPA's layout
        lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)  # noqa: E731,B023
        e = flash_error(label, run(), twin())
        nbytes = 4 * bh * s * dh * q.element_size()
        rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
        check = f"max err {e['max_abs_err']:.2g}" + (
            f", {e['max_row_ulps']:.2f} row ulps, {e['max_elem_ulps']:.2f} own "
            f"ulps, {e['elements_past_own_ulp']} of {e['elements']} past their "
            f"own ulp" if "max_row_ulps" in e else "")
        row = record(totals["flash_attention"], "flash_attention",
                     f"{label} [{bh},{s},{dh}] {str(dtype)[6:]}", e["max_abs_err"],
                     run, twin, lib, nbytes, 2 * bh * s * s * dh,
                     summed=label == "smollm layer", check=check, rate=rate)
        row.update(e)
        rows.append(row)
    for label, bh, s, dk, dv, chunk in MLSTM_CASES:
        q = torch.randn((bh, s, dk), generator=gen, device=dev) * dk ** -0.5
        k = torch.randn((bh, s, dk), generator=gen, device=dev)
        v = torch.randn((bh, s, dv), generator=gen, device=dev)
        logi = torch.randn((bh, s), generator=gen, device=dev)
        logf = F.logsigmoid(torch.randn((bh, s), generator=gen, device=dev) + 2)
        args = (q, k, v, logi, logf)
        run = lambda: ops.mlstm_chunked(*args, chunk=chunk)  # noqa: E731,B023
        twin = lambda: mlstm_chunked_ref(*args, chunk=chunk)  # noqa: E731,B023
        err = mlstm_error(label, run(), twin())
        ln = min(chunk, s)
        ops_n = (s // ln) * bh * (ln * (ln + 1) * (dk + dv) + 4 * ln * dk * dv)
        nbytes = 4 * (bh * s * (2 * dk + 2 * dv + 2) + bh * (dk * dv + dk + 1))
        row = record(totals["mlstm_chunked"], "mlstm_chunked",
                     f"{label} [{bh},{s},{dk},{dv}] L{ln}", err["max_abs_err"],
                     run, twin, None, nbytes, ops_n, summed=label == "xlstm layer",
                     check=(f"max err y {err['y']:.2g} C {err['C']:.2g} n "
                            f"{err['n']:.2g} ({err['max_of_limit']:.2f} of the "
                            "limit), m equal"))
        row.update(err)
        # the same products as 3xTF32 passes on the tensor cores, the design
        # the kernel runs (its bound_ms keeps the float32 rate)
        row["tc_bound_ms"] = bound_ms(nbytes, 3 * ops_n, TF32_OPS_PER_S)[0]
        print(f"    3xTF32 bound {row['tc_bound_ms']:.5f} ms", flush=True)
        if label == "xlstm layer":
            totals["mlstm_chunked"]["tc_bound_ms"] = row["tc_bound_ms"]
            # the call's five kernels: the gates within chunks and their
            # chain, the intra-chunk weights, the chunk states, the outputs
            row["breakdown"] = device_breakdown(run, top=5)
            print("    its kernels: " + (row["breakdown"] if isinstance(
                row["breakdown"], str) else ", ".join(
                    f"{n.split('(')[0].split()[-1]} {ms:.3f} ms"
                    for n, ms, _ in row["breakdown"][:-1])), flush=True)
        rows.append(row)


def launches_per_forward(path: str) -> dict:
    """Kernel launches one forward of the BNN makes on ``path``:
    ``direct``/``im2col`` (the per-layer ``xnor`` engine) one per binary
    conv (direct conv, or the im2col GEMM), one fused GEMM per hidden
    FC, one xnor_gemm for the head; ``megakernel`` one launch per conv
    stage and one for the FC trunk. A Table 2 preset of ``bnn_apply``
    (``PAPER_KERNEL`` ...): ``pack_rows`` + ``xnor_gemm`` per binary
    layer, or ``direct_conv`` for the convs and ``pack_rows`` +
    ``xnor_gemm`` for the FCs, or one ``unpack_gemm`` per binary layer;
    none for the plain-torch and float presets."""
    from repro_torch.core.bnn import CONV_CHANNELS, CONV_STAGES, FC_SIZES
    from repro_torch.kernels import ops

    counts = dict.fromkeys(ops.LAUNCHES, 0)
    convs, fcs = len(CONV_CHANNELS) - 1, len(FC_SIZES)
    if path == "megakernel":
        counts.update(megakernel_conv_stage=len(CONV_STAGES),
                      megakernel_chain=1)
    elif path == "direct":
        counts.update(xnor_gemm=1, fused_xnor_gemm=fcs - 1,
                      fused_direct_conv=convs)
    elif path == "im2col":
        counts.update(xnor_gemm=1, fused_xnor_gemm=fcs - 1 + convs)
    elif path == "PAPER_KERNEL":
        counts.update(pack_rows=convs + fcs, xnor_gemm=convs + fcs)
    elif path == "DIRECT_KERNEL":
        counts.update(direct_conv=convs, pack_rows=fcs, xnor_gemm=fcs)
    elif path == "MXU_KERNEL":
        counts.update(unpack_gemm=convs + fcs)
    elif path not in ("XLA_PACKED", "CONTROL_GROUP", "SIMULATION"):
        raise ValueError(f"unknown path {path!r}")
    return counts


def serve_phase(dev) -> dict:
    from repro_torch.core.bnn import (bnn_apply_fused, bnn_apply_megakernel,
                                      first_conv_packed,
                                      load_binary_checkpoint,
                                      pack_bnn_params_fused,
                                      pack_bnn_params_megakernel)
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_bnn import random_requests
    from repro_torch.serve import (ContinuousServingEngine, FallbackPolicy,
                                   ServingEngine, default_extents, is_error)

    latent = load_binary_checkpoint(CKPT, device=dev)
    packed = pack_bnn_params_fused(latent)
    mega = pack_bnn_params_megakernel(latent)
    rng = np.random.default_rng(0)
    requests = random_requests(rng, count=12, max_images=8)
    result = {"requests": len(requests),
              "images": sum(r.shape[0] for r in requests)}

    engines, launches = {}, {}
    for path in ("direct", "im2col", "megakernel"):
        # This path's counts: 0 just before its engine is built, read
        # just after its drain.
        ops.reset_launches()
        t0 = time.monotonic()
        # max_wait 0: every step dispatches what is queued, so the
        # ragged requests reach several buckets or extent classes.
        if path == "megakernel":
            eng = ContinuousServingEngine(
                mega, engine="megakernel", max_wait_s=0.0,
                fallback=FallbackPolicy(fused_params=packed, mega_params=mega))
            if eng.warmup() != len(default_extents(32)):
                fail(f"megakernel: {len(eng.extents)} extent classes warmed, "
                     f"expected {default_extents(32)}")
        else:
            eng = ServingEngine(packed, engine="xnor", conv_impl=path,
                                max_wait_s=0.0)
            eng.warmup()
        t1 = time.monotonic()
        rids = []
        for imgs in requests:
            rids.append(eng.submit(imgs))
            eng.step()
        eng.drain()
        torch.cuda.synchronize()
        t2 = time.monotonic()
        launches[path] = dict(ops.LAUNCHES)
        engines[path] = (eng, [eng.take(r) for r in rids])
        result[f"{path}_warmup_s"] = t1 - t0
        result[f"{path}_serve_s"] = t2 - t1
    result["launches"] = launches

    for path, (eng, got) in engines.items():
        snap = eng.snapshot()
        # Every warmed bucket or extent class ran one forward, then every
        # served batch.
        shapes = eng.extents if path == "megakernel" else eng.batcher.buckets
        forwards = len(shapes) + snap["batches"]["dispatched"]
        expected = {k: v * forwards
                    for k, v in launches_per_forward(path).items()}
        if launches[path] != expected:
            fail(f"{path}: kernel launches {launches[path]} over "
                 f"{forwards} forwards, expected {expected}")
        if snap["dispatch"]["fallbacks"] or snap["degraded"]:
            fail(f"{path}: engine failover recorded: "
                 f"{snap['dispatch']['engine_path']}")
        if snap["requests"]["completed"] != len(requests):
            fail(f"{path}: {snap['requests']['completed']} of "
                 f"{len(requests)} requests completed")
        for i, (imgs, logits) in enumerate(zip(requests, got)):
            if logits is None or is_error(logits):
                fail(f"{path}: request {i} has no logits: {logits}")
            with torch.inference_mode():
                want = bnn_apply_fused(
                    packed, torch.from_numpy(imgs).to(dev), engine="xla",
                    conv_impl="direct" if path == "megakernel"
                    else path).cpu().numpy()
            if logits.shape != (imgs.shape[0], 10) or not np.isfinite(logits).all():
                fail(f"{path}: request {i} logits {logits.shape}, finite="
                     f"{np.isfinite(logits).all()}")
            if not np.array_equal(logits, want):
                fail(f"{path}: request {i}: served logits differ "
                     f"from the xla forward (max abs "
                     f"{np.abs(logits - want).max()})")
        print(f"  serve {eng.executors.engine}/{path}: {len(requests)} "
              f"requests ({result['images']} images) bit-identical to xla; "
              f"warmup {result[f'{path}_warmup_s']:.3f} s, serve "
              f"{result[f'{path}_serve_s']:.3f} s, batch shapes "
              f"{snap['batches']['per_bucket']}", flush=True)
        print(f"  launches on the {path} path ({forwards} forwards): "
              f"{launches[path]}", flush=True)
    # Reference on a small input: the card's forward against the CPU's
    # plain-torch forward of the same 4 images.
    imgs = torch.from_numpy(requests[0][:4].copy())
    packed_cpu = pack_bnn_params_fused(load_binary_checkpoint(CKPT, device="cpu"))
    with torch.inference_mode():
        cpu = bnn_apply_fused(packed_cpu, imgs, engine="xla", conv_impl="direct")
        gpu = bnn_apply_fused(packed, imgs.to(dev), engine="xnor",
                              conv_impl="direct").cpu()
        flips = int((first_conv_packed(packed_cpu, imgs)
                     != first_conv_packed(packed, imgs.to(dev)).cpu()).sum())
    diff = float((cpu - gpu).abs().max())
    result.update(cpu_vs_gpu_max_abs=diff, cpu_vs_gpu_first_conv_words=flips)
    print(f"  card vs CPU on {imgs.shape[0]} images: max |logit diff| {diff}, "
          f"first-conv words differing {flips}", flush=True)
    if not torch.allclose(cpu, gpu, rtol=1e-5, atol=1e-4) or not torch.equal(
            cpu.argmax(1), gpu.argmax(1)):
        fail("card logits disagree with the CPU plain-torch forward")

    # Whole forward at batch 32, by CUDA events: as called (eager) and
    # replayed from a CUDA graph (device time only, no host gaps).
    x32 = torch.from_numpy(rng.normal(size=(BATCH, 32, 32, 3)).astype(
        np.float32)).to(dev)
    with torch.inference_mode():
        for engine, conv_impl in (("xnor", "direct"), ("xnor", "im2col"),
                                  ("megakernel", "stages"), ("xla", "direct")):
            if engine == "megakernel":
                fwd = lambda: bnn_apply_megakernel(  # noqa: E731
                    mega, x32, engine="xnor", ragged=True)
            else:
                fwd = lambda: bnn_apply_fused(  # noqa: E731
                    packed, x32, engine=engine, conv_impl=conv_impl)  # noqa: B023
            ms = time_ms(fwd, iters=1 if engine == "xla" else 10, reps=3)
            result[f"forward_b32_{engine}_{conv_impl}_ms"] = ms
            line = f"  forward batch {BATCH} {engine}/{conv_impl}: {ms:.3f} ms"
            if engine != "xla":
                gms = graph_ms(fwd, iters=5)
                result[f"forward_b32_{engine}_{conv_impl}_graph_ms"] = gms
                # The share of the eager forward the device waits on the host.
                result[f"forward_b32_{engine}_{conv_impl}_idle"] = 1 - gms / ms
                line += (f" eager, {gms:.3f} ms replayed from a CUDA graph "
                         f"(device idle {1 - gms / ms:.2f} of the eager call)")
            print(line, flush=True)
        fc = lambda: first_conv_packed(packed, x32)  # noqa: E731
        result["first_conv_b32_ms"] = time_ms(fc, iters=10, reps=3)
        result["first_conv_b32_graph_ms"] = graph_ms(fc, iters=5)
        print(f"  first conv + BN + pack, batch {BATCH}: "
              f"{result['first_conv_b32_ms']:.3f} ms eager, "
              f"{result['first_conv_b32_graph_ms']:.3f} ms graph", flush=True)
    return result


def unfused_kernel_phase(dev, totals: dict, rows: list, batch: int,
                         summed: bool, parents=None) -> None:
    """The unfused PACKED kernels at the eight binary layers of the Table
    2 forward at ``batch``: ``pack_rows`` on the transposed ``[B*HW, K]``
    patch matrix (read in place; timed with a cold L2, see ``graph_ms``),
    ``unpack_gemm`` on the binarized patches (exact) and on the real ones
    (within rtol 1e-5 / atol 1e-4 of the float64-accumulated dot),
    ``direct_conv`` at the five convs (beside the parent commit's kernel,
    ``parents``, and a bf16 ``F.conv2d``). Inputs in [-1, 1] with some 0.0
    and -0.0, as the clipped activations the layers encode. ``summed``:
    these are the main path's shapes, whose times make the kernels'
    totals."""
    from repro_torch.core import bitops
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(2 + batch)
    cpu_gen = torch.Generator().manual_seed(3 + batch)
    F = torch.nn.functional
    tag = f" b{batch}"
    layers = [(label, 9 * c, batch * h * h, d) for label, h, c, d in conv_cases()]
    layers += [("fc0", 8192, batch, 1024), ("fc1", 1024, batch, 1024),
               ("head", 1024, batch, 10)]
    for label, k, n, m in layers:
        x2d = torch.rand((n, k), generator=gen, device=dev) * 2 - 1
        x2d.view(-1)[::97] = 0.0
        x2d.view(-1)[::89] = -0.0
        xt = x2d.T                                   # [K, N], K-contiguous
        err = check_equal("pack_rows", label + tag, ops.pack_rows(xt),
                          bitops.pack_bits(xt, axis=0).contiguous())
        row = record(
            totals["pack_rows"], "pack_rows", f"{label} [{k},{n}]", err,
            lambda: ops.pack_rows(xt), lambda: bitops.pack_bits(xt, axis=0),  # noqa: B023
            None, k * n * 4 + k * n // 8, k * n, summed=summed, cold=True)
        # The copy reading the view in place avoids.
        row["contiguous_copy_ms"] = graph_ms(xt.contiguous, iters=5)
        rows.append(row)

        wp = rand_words(cpu_gen, (m, k // 32), dev)
        xpm = torch.sign(x2d) + (x2d == 0).float()   # the layer's binarize
        xpt = xpm.T
        run = lambda: ops.unpack_gemm(wp, xpt)  # noqa: E731,B023
        twin = lambda: bitops.packed_matmul_unpack(  # noqa: E731
            wp, xpt, compute_dtype=torch.float32)  # noqa: B023
        err = check_equal("unpack_gemm", label + tag, run(), twin())
        ref64 = bitops.packed_matmul_unpack(wp, xt, compute_dtype=torch.float32,
                                            accum_dtype=torch.float64)
        real = ops.unpack_gemm(wp, xt).double()
        dev_err = (real - ref64).abs()
        bad = int((dev_err > 1e-4 + 1e-5 * ref64.abs()).sum())
        twin32 = bitops.packed_matmul_unpack(wp, xt, compute_dtype=torch.float32)
        twin_err = float((twin32.double() - ref64).abs().max())
        print(f"  unpack_gemm real input {label}{tag}: max |kernel - f64 dot| "
              f"{float(dev_err.max()):.3g} ({bad} outside rtol 1e-5/atol 1e-4), "
              f"fp32 twin {twin_err:.3g}, |kernel - fp32 twin| "
              f"{float((real - twin32.double()).abs().max()):.3g}", flush=True)
        if bad:
            fail(f"unpack_gemm {label}{tag}: {bad} outputs on real input outside "
                 "rtol 1e-5 / atol 1e-4 of the float64-accumulated dot")
        wf = bitops.unpack_bits(wp, axis=-1)
        row = record(totals["unpack_gemm"], "unpack_gemm", f"{label} [{m},{k}]x[{k},{n}]",
                     err, run, twin, lambda: torch.matmul(wf, xpt),  # noqa: B023
                     (m * k // 32 + k * n + m * n) * 4, 2 * m * n * k,
                     summed=summed)
        row["real_input_max_abs_err"] = float(dev_err.max())
        totals["unpack_gemm"]["real_input_max_abs_err"] = max(
            totals["unpack_gemm"].get("real_input_max_abs_err", 0.0),
            row["real_input_max_abs_err"])
        rows.append(row)

    for label, h, c, d in conv_cases():
        cw, k_bits = c // 32, 9 * c
        x = rand_words(cpu_gen, (batch, h, h, cw), dev)
        w = rand_words(cpu_gen, (d, 9 * cw), dev)
        run = lambda: ops.direct_conv(w, x, k_bits, kh=3, kw=3, stride=1, pad=1)  # noqa: E731,B023
        twin = lambda: bitops.direct_conv_dot(  # noqa: E731
            w, x, k_bits, kh=3, kw=3, stride=1, pad=1)  # noqa: B023
        want = twin()
        err = check_equal("direct_conv", label + tag, run(), want)
        parent = None
        if isinstance(parents, dict):
            parent = parent_direct_conv_dot(parents["direct_conv"], w, x, k_bits)
            check_equal("parent direct_conv", label + tag, parent(), want)
        # Yardsticks: F.conv2d of the ±1 map, pre-padded with +1 (the
        # binary border), and the ±1 filters, NCHW, TF32 off; and the same
        # in bf16 (a timing yardstick only: its outputs round).
        xf = F.pad(bitops.unpack_bits(x, axis=-1).permute(0, 3, 1, 2),
                   (1, 1, 1, 1), value=1.0).contiguous()
        wf = bitops.unpack_bits(w, axis=-1).reshape(d, 3, 3, c).permute(
            0, 3, 1, 2).contiguous()
        xh, wh = xf.bfloat16(), wf.bfloat16()
        rows.append(record(
            totals["direct_conv"], "direct_conv", label + tag, err, run, twin,
            lambda: F.conv2d(xf, wf),  # noqa: B023
            (x.numel() + w.numel() + batch * h * h * d) * 4,
            2 * batch * h * h * d * k_bits, plain_reps=2, summed=summed,
            parent=parent, lib_bf16=lambda: F.conv2d(xh, wh)))  # noqa: B023


# jamba-1.5-large's decode step through the packed GEMM (ROADMAP A7b): one
# expert's [8192, 8192] projection, packed, at batch 4 with bf16
# activations, as ``bit_linear`` passes them (the transposed [4, 8192]).
DECODE_CASE = ("jamba decode", 8192, 8192, 4)


def unpack_decode_phase(dev, totals: dict, rows: list) -> None:
    """``unpack_gemm`` at ``DECODE_CASE``: exact on ±1/0 input, within
    rtol 1e-5 / atol 1e-4 of the float64 dot on real input in [-1, 1];
    timed beside bf16 ``torch.matmul`` on the unpacked bf16 weights. Off
    the main path: not summed."""
    from repro_torch.core import bitops
    from repro_torch.kernels import ops

    label, m, k, n = DECODE_CASE
    gen = torch.Generator(device=dev).manual_seed(5)
    wp = rand_words(torch.Generator().manual_seed(6), (m, k // 32), dev)
    x2d = torch.rand((n, k), generator=gen, device=dev) * 2 - 1
    xpt = (torch.sign(x2d) + (x2d == 0).float()).to(torch.bfloat16).T
    xt = x2d.to(torch.bfloat16).T
    run = lambda: ops.unpack_gemm(wp, xpt)  # noqa: E731
    twin = lambda: bitops.packed_matmul_unpack(  # noqa: E731
        wp, xpt, compute_dtype=torch.bfloat16)
    err = check_equal("unpack_gemm", label, run(), twin())
    ref64 = bitops.packed_matmul_unpack(wp, xt, compute_dtype=torch.bfloat16,
                                        accum_dtype=torch.float64)
    dev_err = (ops.unpack_gemm(wp, xt).double() - ref64).abs()
    bad = int((dev_err > 1e-4 + 1e-5 * ref64.abs()).sum())
    print(f"  unpack_gemm real input {label}: max |kernel - f64 dot| "
          f"{float(dev_err.max()):.3g} ({bad} outside rtol 1e-5/atol 1e-4)",
          flush=True)
    if bad:
        fail(f"unpack_gemm {label}: {bad} outputs on real input outside "
             "rtol 1e-5 / atol 1e-4 of the float64-accumulated dot")
    wb = bitops.unpack_bits(wp, axis=-1, dtype=torch.bfloat16)
    row = record(totals["unpack_gemm"], "unpack_gemm",
                 f"{label} [{m},{k}]x[{k},{n}] bf16", err, run, twin,
                 lambda: torch.matmul(wb, xpt), m * k // 8 + k * n * 2 + m * n * 4,
                 2 * m * n * k, summed=False)
    row["real_input_max_abs_err"] = float(dev_err.max())
    rows.append(row)


def preset_twins() -> dict:
    """The plain twin of each kernel a Table 2 preset launches, called as
    its wrapper calls it on CPU tensors."""
    from repro_torch.core import bitops

    return {
        "pack_rows": lambda x: bitops.pack_bits(x, axis=0).contiguous(),
        "xnor_gemm": bitops.xnor_popcount_matmul,
        "direct_conv": bitops.direct_conv_dot,
        "unpack_gemm": lambda wp, x: bitops.packed_matmul_unpack(
            wp, x, compute_dtype=x.dtype),
    }


@contextlib.contextmanager
def recorded_calls(names):
    """Within the block, every call of the wrappers ``names`` of
    ``repro_torch.kernels.ops`` is kept as (name, args, kwargs, output);
    the wrappers are restored on exit. The recorded launches are the
    forward's own: none is added."""
    from repro_torch.kernels import ops

    calls, originals = [], {name: getattr(ops, name) for name in names}

    def recording(name, wrapper):
        def call(*args, **kwargs):
            out = wrapper(*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out
        return call

    for name, wrapper in originals.items():
        setattr(ops, name, recording(name, wrapper))
    try:
        yield calls
    finally:
        for name, wrapper in originals.items():
            setattr(ops, name, wrapper)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def device_breakdown(fn, top: int = 6) -> list:
    """Device time of one call of ``fn`` by kernel name (``torch.profiler``),
    the ``top`` largest as ``[name, ms, share]``. The profile is
    diagnostic: an error of the profiler itself gives "not measured", but
    an error of ``fn`` (a kernel or a wrapper) propagates."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except Exception as err:
        return f"not measured: {err!r}"
    stop_error = None
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        try:
            prof.stop()
        except Exception as err:
            stop_error = err
    if stop_error is not None:
        return f"not measured: {stop_error!r}"
    try:
        events = prof.key_averages()
    except Exception as err:
        return f"not measured: {err!r}"
    times = {}
    for evt in events:
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        if us:
            times[evt.key] = times.get(evt.key, 0.0) + us / 1e3
    total = sum(times.values()) or 1.0
    ranked = sorted(times.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:60], ms, ms / total] for name, ms in ranked] + [["total", total, 1.0]]


def table2_phase(dev) -> dict:
    """Table 2 on the card: the six presets on the trained checkpoint at
    Table 2's batch, each preset's launches counted over one forward. Every
    kernel call of that forward is held, bit for bit, against its plain
    twin on the same inputs; the eager time is the mean over the
    experiment's ``num_batches`` forwards."""
    from repro_torch.configs.bnn_cifar import PRESETS, BNNExperiment
    from repro_torch.core.binarize import QuantMode
    from repro_torch.core.bnn import (bnn_apply, bnn_apply_fused,
                                      load_binary_checkpoint, pack_bnn_params,
                                      pack_bnn_params_fused)
    from repro_torch.kernels import ops

    exp = BNNExperiment("table2")
    batch = exp.batch
    twins = preset_twins()
    latent = load_binary_checkpoint(CKPT, device=dev)
    latent_cpu = load_binary_checkpoint(CKPT, device="cpu")
    packed = pack_bnn_params(latent)
    images = np.random.default_rng(64).normal(size=(batch, 32, 32, 3)).astype(
        np.float32)
    x = torch.from_numpy(images).to(dev)
    result = {"experiment": exp.name, "batch": batch,
              "num_batches": exp.num_batches, "launches": {}, "presets": {}}
    with torch.inference_mode():
        ref = bnn_apply_fused(pack_bnn_params_fused(latent), x, engine="xla")
        for name, cfg in PRESETS.items():
            is_packed = cfg.mode == QuantMode.PACKED
            params = packed if is_packed else latent
            fwd = lambda: bnn_apply(params, x, cfg)  # noqa: E731,B023
            # This preset's counts: 0 just before its checked forward,
            # read just after.
            ops.reset_launches()
            with recorded_calls(twins) as calls:
                logits = fwd()
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            result["launches"][name] = launches
            if launches != launches_per_forward(name):
                fail(f"{name}: kernel launches {launches} in one forward, "
                     f"expected {launches_per_forward(name)}")
            for i, (kname, args, kwargs, out) in enumerate(calls):
                check_equal(kname, f"{name} call {i}", out,
                            twins[kname](*args, **kwargs))
            row = {"weight_bytes": _nbytes(params),
                   "kernel_calls_checked": len(calls)}
            del calls
            if logits.shape != (batch, 10) or not torch.isfinite(logits).all():
                fail(f"{name}: logits {tuple(logits.shape)} not finite [{batch}, 10]")
            if name != "CONTROL_GROUP":
                if not torch.equal(logits, ref):
                    fail(f"{name}: logits differ from the fused xla forward "
                         f"(max abs {float((logits - ref).abs().max())})")
                check = "bit-identical to fused xla"
            else:
                # Float layers pad borders with 0, not +1: its own logits.
                cpu = bnn_apply(latent_cpu, torch.from_numpy(images[:4]), cfg)
                diff = float((logits[:4].cpu() - cpu).abs().max())
                row["cpu_vs_gpu_max_abs"] = diff
                if not torch.allclose(logits[:4].cpu(), cpu, rtol=1e-5,
                                      atol=1e-4) or not torch.equal(
                                          logits[:4].cpu().argmax(1), cpu.argmax(1)):
                    fail(f"{name}: card logits disagree with the CPU forward "
                         f"(max abs {diff})")
                check = f"within {diff:.3g} of its CPU forward on 4 images"
            row["eager_ms"] = time_ms(fwd, iters=exp.num_batches, reps=3)
            row["graph_ms"] = graph_ms(fwd, iters=3)
            row["device_breakdown"] = device_breakdown(fwd)
            result["presets"][name] = row
            if row["kernel_calls_checked"]:
                check += (f"; its {row['kernel_calls_checked']} kernel calls "
                          "equal their twins")
            print(f"  {name:13s} {check}; launches/forward "
                  f"{ {k: v for k, v in launches.items() if v} }; device "
                  f"{row['graph_ms']:.3f} ms (graph), eager {row['eager_ms']:.3f} "
                  f"ms; weights {row['weight_bytes']} B", flush=True)
            if isinstance(row["device_breakdown"], str):
                print(f"    profile {row['device_breakdown']}", flush=True)
            else:
                for kname, ms, share in row["device_breakdown"]:
                    print(f"    {ms:8.4f} ms {share:6.1%}  {kname}", flush=True)
    p = result["presets"]
    for kind in ("graph_ms", "eager_ms"):
        result[f"control_over_paper_{kind}"] = (
            p["CONTROL_GROUP"][kind] / p["PAPER_KERNEL"][kind])
    print(f"  CONTROL_GROUP / PAPER_KERNEL at batch {batch}: "
          f"{result['control_over_paper_graph_ms']:.3f}x device, "
          f"{result['control_over_paper_eager_ms']:.3f}x eager", flush=True)
    return result


# Phase 6: one full-width period of jamba-1.5-large-398b, served.
JAMBA_LAYERS, JAMBA_BATCH, JAMBA_PROMPT, JAMBA_GEN = 8, 4, 512, 8
# Kernel path vs twin path, |diff| <= atol + rtol * |twin logit|. Stated
# before the first run on the card, for bf16 activations: the kernel sums
# y over the state in another order than the twin, so a y can move by an
# ulp; where that crosses a bf16 rounding boundary an activation moves by
# 2^-8 of itself, and such moves pass through 8 layers (and could tip a
# near-tied MoE top-2 choice). Logits are O(1) (|logit| up to ~5 for an
# RMS-normed x against N(0, 1/d) head rows); a wrong kernel is caught by
# the per-call checks at 1e-5 and moves logits by far more.
JAMBA_LOGIT_TOL = dict(rtol=2e-2, atol=5e-2)
# The same comparison for the prefill with float32 activations (the
# config's dtype replaced; same params): no bf16 rounding to amplify an
# ulp of y, so only float32 reassociation through 8 layers remains.
JAMBA_F32_LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)


def _proj_bytes(tree) -> tuple[int, int]:
    """(bytes of the packed projection weights and their alphas, bytes of
    the same weights in bfloat16)."""
    if isinstance(tree, list):
        parts = [_proj_bytes(v) for v in tree]
    elif isinstance(tree, dict) and "w_packed" in tree:
        w = tree["w_packed"]
        alpha = tree.get("alpha")
        packed = w.numel() * 4 + (alpha.numel() * 4 if alpha is not None else 0)
        return packed, w.numel() * 32 * 2
    elif isinstance(tree, dict):
        parts = [_proj_bytes(v) for v in tree.values()]
    else:
        return 0, 0
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def events_ms(fn, reps: int = 3) -> float:
    """Median device-clock time of one call (CUDA events around it) after
    one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def jamba_phase(dev, cfg=None) -> dict:
    """Serve one full-width period of jamba-1.5-large-398b (8 layers: 7
    mamba, 1 attention; 4 MoE of 16 experts, 4 dense FFNs; vocab 65536)
    from 1-bit packed weights through ``launch.serve.serve_config``:
    ``init_packed`` on the card from a seeded generator, batch 4, a
    512-token prompt (two scan chunks), 8 greedy tokens, f32 KV cache.

    The launch counts are 0 just before the prefill and read after it
    (14 scan launches, nothing else) and after each decode step (none);
    every scan call of the prefill is held against its twin on its own
    inputs. The same model is run again with the twin in place of the
    kernel (swapped here, for that run only), teacher-forced with the
    kernel path's tokens, and its logits held to ``JAMBA_LOGIT_TOL``."""
    import dataclasses

    from repro_torch.configs.base import get_config, serve_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssm_scan_chunk_ref
    from repro_torch.launch.serve import serve_config
    from repro_torch.models.model_factory import build_model

    if cfg is None:
        cfg = dataclasses.replace(get_config("jamba-1.5-large-398b"),
                                  num_layers=JAMBA_LAYERS)
    policy = serve_policy()
    model = build_model(cfg, policy)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    params = model.init_packed(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    packed_b, bf16_b = _proj_bytes(params)
    result = {"config": {"name": cfg.name, "num_layers": cfg.num_layers,
                         "d_model": cfg.d_model, "num_experts": cfg.num_experts,
                         "vocab_size": cfg.vocab_size, "dtype": str(cfg.dtype)},
              "init_packed_s": time.monotonic() - t0,
              "packed_weight_bytes": packed_b, "bf16_weight_bytes": bf16_b,
              "param_bytes": _nbytes(params)}
    print(f"  init_packed: {result['init_packed_s']:.1f} s; projection weights "
          f"{packed_b / 1e9:.3f} GB packed (with alphas) vs {bf16_b / 1e9:.1f} "
          f"GB in bf16 ({bf16_b / packed_b:.1f}x); all params "
          f"{result['param_bytes'] / 1e9:.2f} GB", flush=True)

    logits_k, launches = [], []

    def on_step(step, logits):
        torch.cuda.synchronize()
        launches.append(dict(ops.LAUNCHES))
        ops.reset_launches()
        logits_k.append(logits.float().clone())

    with recorded_calls(["ssm_scan_chunk"]) as calls:
        # The counts: 0 just before the prefill (serve_config launches
        # nothing before it), read after it and after each decode step.
        ops.reset_launches()
        served = serve_config(cfg, policy, batch=JAMBA_BATCH,
                              prompt_len=JAMBA_PROMPT, gen=JAMBA_GEN, seed=0,
                              cache_dtype=torch.float32, device=dev,
                              params=params, on_step=on_step)
    n_mamba = sum(not cfg.is_attention_layer(i) for i in range(cfg.num_layers))
    chunks = -(-JAMBA_PROMPT // 256)
    want = {**dict.fromkeys(ops.LAUNCHES, 0), "ssm_scan_chunk": n_mamba * chunks}
    if launches[0] != want:
        fail(f"jamba prefill: launches {launches[0]}, expected {want}")
    for step, counts in enumerate(launches[1:], start=1):
        if any(counts.values()):
            fail(f"jamba decode step {step}: launches {counts}, expected none")
    if len(calls) != want["ssm_scan_chunk"]:
        fail(f"jamba: {len(calls)} scan calls recorded, expected "
             f"{want['ssm_scan_chunk']}")
    result["launches"] = {"prefill": launches[0], "decode": launches[1:]}
    result["scan_calls_max_abs_err"] = max(
        scan_error("ssm_scan_chunk", f"jamba prefill call {i}", out,
                   ssm_scan_chunk_ref(*args, **kwargs))
        for i, (_, args, kwargs, out) in enumerate(calls))
    del calls
    tokens = served["tokens"]
    if tokens.shape != (JAMBA_BATCH, JAMBA_GEN) or len(logits_k) != JAMBA_GEN:
        fail(f"jamba: tokens {tuple(tokens.shape)}, {len(logits_k)} logit steps")
    for step, lg in enumerate(logits_k):
        if lg.shape != (JAMBA_BATCH, cfg.vocab_size) or not torch.isfinite(lg).all():
            fail(f"jamba step {step}: logits {tuple(lg.shape)} not finite "
                 f"[{JAMBA_BATCH}, {cfg.vocab_size}]")
    print(f"  served {JAMBA_BATCH} x {JAMBA_PROMPT} prompt + {JAMBA_GEN} tokens: "
          f"prefill launched {launches[0]['ssm_scan_chunk']} scans "
          f"({n_mamba} mamba layers x {chunks} chunks), each within "
          f"{result['scan_calls_max_abs_err']:.2g} of its twin; decode steps "
          f"none; host clock prefill {served['prefill_s']:.3f} s, decode "
          f"{served['decode_s']:.3f} s", flush=True)

    # The same model with the plain twin in place of the kernel,
    # teacher-forced with the kernel path's tokens.
    prompts = served["prompts"]
    state0 = model.init_state(JAMBA_BATCH, JAMBA_PROMPT + JAMBA_GEN,
                              dtype=torch.float32, device=dev)

    def run(m, scan, steps):
        """Logits of the prefill and ``steps`` teacher-forced decode steps
        of model ``m`` with ``scan`` as ``ops.ssm_scan_chunk``."""
        kernel = ops.ssm_scan_chunk
        ops.ssm_scan_chunk = scan
        try:
            with torch.inference_mode():
                lg, state = m.prefill(params, state0, {"tokens": prompts})
                out = [lg.float()]
                for step in range(steps):
                    lg, state = m.decode_step(
                        params, state, {"tokens": tokens[:, step:step + 1]})
                    out.append(lg.float())
        finally:
            ops.ssm_scan_chunk = kernel
        return out

    def held(what, got, want, tol) -> list:
        errs = []
        for step, (k, t) in enumerate(zip(got, want)):
            diff = (k - t).abs()
            errs.append(float(diff.max()))
            bad = int((diff > tol["atol"] + tol["rtol"] * t.abs()).sum())
            if bad:
                fail(f"jamba {what} step {step}: {bad} logits outside {tol} "
                     f"(max abs diff {errs[-1]:.3g})")
        return errs

    logits_t = run(model, ssm_scan_chunk_ref, JAMBA_GEN - 1)
    errs = held("kernel vs twin path", logits_k, logits_t, JAMBA_LOGIT_TOL)
    agree = sum(int((k.argmax(-1) == t.argmax(-1)).sum())
                for k, t in zip(logits_k, logits_t))
    # Diagnostics: the kernel path's prefill once more (run to run), and
    # kernel vs twin prefill with float32 activations.
    rerun = run(model, ops.ssm_scan_chunk, 0)
    model32 = build_model(dataclasses.replace(cfg, dtype=torch.float32), policy)
    f32_k = run(model32, ops.ssm_scan_chunk, 0)
    f32_t = run(model32, ssm_scan_chunk_ref, 0)
    f32_errs = held("float32-activation prefill, kernel vs twin", f32_k, f32_t,
                    JAMBA_F32_LOGIT_TOL)
    result.update(logits_max_abs_diff=errs,
                  logits_abs_max=float(max(t.abs().max() for t in logits_t)),
                  greedy_agreement=f"{agree}/{JAMBA_BATCH * JAMBA_GEN}",
                  prefill_rerun_max_abs_diff=float((rerun[0] - logits_k[0]).abs().max()),
                  f32_prefill_max_abs_diff=f32_errs[0])
    print(f"  kernel vs twin path (bf16 activations): max |logit diff| per step "
          f"{[f'{e:.3g}' for e in errs]} (|logits| up to "
          f"{result['logits_abs_max']:.3g}; tolerance {JAMBA_LOGIT_TOL}); greedy "
          f"tokens agree {result['greedy_agreement']}; kernel path prefill run "
          f"again: max |diff| {result['prefill_rerun_max_abs_diff']:.3g}; "
          f"float32 activations, kernel vs twin prefill: max |diff| "
          f"{f32_errs[0]:.3g} (tolerance {JAMBA_F32_LOGIT_TOL})", flush=True)
    del model32, f32_k, f32_t, rerun

    # Device-clock times (CUDA events) and profiles of one prefill and one
    # decode step (functional: the state given is not written).
    with torch.inference_mode():
        batch_p = {"tokens": prompts}
        batch_d = {"tokens": tokens[:, -1:]}
        _, state1 = model.prefill(params, state0, batch_p)
        result["prefill_ms"] = events_ms(
            lambda: model.prefill(params, state0, batch_p), reps=2)
        result["decode_ms_per_token"] = events_ms(
            lambda: model.decode_step(params, state1, batch_d), reps=3)
        result["prefill_breakdown"] = device_breakdown(
            lambda: model.prefill(params, state0, batch_p))
        result["decode_breakdown"] = device_breakdown(
            lambda: model.decode_step(params, state1, batch_d))
    result["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    print(f"  prefill {result['prefill_ms']:.1f} ms, decode "
          f"{result['decode_ms_per_token']:.1f} ms per token (batch "
          f"{JAMBA_BATCH}; CUDA events); max_memory_allocated "
          f"{result['max_memory_allocated'] / 1e9:.2f} GB", flush=True)
    for what in ("prefill", "decode"):
        top = result[f"{what}_breakdown"]
        print(f"    {what} profile: "
              + (top if isinstance(top, str) else ""), flush=True)
        if not isinstance(top, str):
            for kname, ms, share in top:
                print(f"    {ms:10.3f} ms {share:6.1%}  {kname}", flush=True)
    return result


# Phase 7: the LM training forward (Model.loss) at full width.
# (arch, batch, kernel it must launch, launches per forward, whether its
# bf16 logits are held to LM_LOGIT_TOL): the train_4k shape's sequence of
# 4096 tokens, its batch of 256 cut to 4 / 2. xlstm-1.3b's bf16 logits
# are reported, not held: on an H100 a one-float32-ulp nudge of the
# mLSTM output in the twin path moves them by 3.1 (more than the kernel
# does), so they measure the random-weight model's bf16 sensitivity, not
# the kernel. Its kernel is held per call, by the bf16 loss and by the
# float32-activation logits and loss.
LM_CASES = [("smollm-360m", 4, "flash_attention", 32, True),
            ("xlstm-1.3b", 2, "mlstm_chunked", 42, False)]
LM_SEQ = 4096
# Kernel path vs twin path, bf16 activations: |loss diff| <= LM_LOSS_TOL
# and |logit diff| <= atol + rtol * |twin logit|. Stated before the first
# run on the card: the kernels differ from their twins by float32 ulps
# (flash: an occasional bf16 flip of p); where such a difference crosses
# a bf16 rounding boundary of an activation it moves by 2^-8 of itself,
# and such moves pass through 32 / 48 layers. On the CPU the smoke smollm
# (2 layers, bf16) moves its logits by 0.045 when only the twin's KV
# block changes (512 to 64). Logits are O(1) (RMS-normed x against
# N(0, 1/d) head rows, |logit| up to ~6); a wrong kernel is caught by the
# per-call checks and moves logits by O(1) everywhere.
LM_LOSS_TOL = 2e-2
LM_LOGIT_TOL = dict(rtol=0.1, atol=0.5)
# The same loss with float32 activations (same params): no bf16 rounding
# to amplify the kernels' float32 ulps. The logits' limit is set from
# the readings on an H100 (xlstm-1.3b 1.7e-3, smollm-360m 1.1e-5): some
# 6x the larger, far below the O(1) a wrong kernel gives.
LM_F32_LOSS_TOL = 1e-3
LM_F32_LOGIT_TOL = dict(rtol=0.0, atol=1e-2)


def logit_diff(got: torch.Tensor, want: torch.Tensor, seq: int,
               tol: dict) -> dict:
    """|got - want| of two ``[B, S, V]`` logit tensors: the max, the max
    over position ranges, the count outside ``tol`` (``atol + rtol *
    |want|``) and the share of positions whose argmax agrees."""
    diff = (got - want).abs()
    per_pos = diff.amax(dim=(0, 2))
    edges = [e for e in (0, 64, 256, 1024, seq) if e <= seq]
    tol = tol["atol"] + tol["rtol"] * want.abs()
    return {"max_abs_diff": float(diff.max()),
            "by_position": {f"{a}-{b}": round(float(per_pos[a:b].max()), 4)
                            for a, b in zip(edges[:-1], edges[1:]) if b > a},
            "abs_max": float(want.abs().max()),
            "outside_tol": int((diff > tol).sum()),
            "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                      .float().mean())}


@contextlib.contextmanager
def checked_calls(name: str, check):
    """Within the block, every call of ``ops.<name>`` is held against its
    twin at once (``check(label, args, kwargs, out)`` returns the call's
    error), so the calls' operands need not be kept; yields the list of
    errors. The forward's own launches are the only ones counted: twins
    launch no kernel."""
    from repro_torch.kernels import ops

    errors, wrapper = [], getattr(ops, name)

    def call(*args, **kwargs):
        out = wrapper(*args, **kwargs)
        errors.append(check(f"call {len(errors)}", args, kwargs, out))
        return out

    setattr(ops, name, call)
    try:
        yield errors
    finally:
        setattr(ops, name, wrapper)


@contextlib.contextmanager
def captured_logits():
    """Within the block, the logits of the last ``lm_forward`` call are
    kept in the yielded list, so one ``Model.loss`` gives its loss and its
    logits."""
    from repro_torch.models import transformer as tf_mod

    kept, forward = [], tf_mod.lm_forward

    def call(*args, **kwargs):
        out = forward(*args, **kwargs)
        kept[:] = [out[0]]
        return out

    tf_mod.lm_forward = call
    try:
        yield kept
    finally:
        tf_mod.lm_forward = forward


@contextlib.contextmanager
def twins_in_place():
    """Within the block the two LM kernels' wrappers are their plain twins
    (flash with the kernel's KV tile)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import mlstm_chunked_ref

    saved = ops.flash_attention, ops.mlstm_chunked
    ops.flash_attention, ops.mlstm_chunked = flash_twin, mlstm_chunked_ref
    try:
        yield
    finally:
        ops.flash_attention, ops.mlstm_chunked = saved


def lm_phase(dev, cases=LM_CASES, seq: int = LM_SEQ) -> dict:
    """``Model.loss`` of smollm-360m (batch 4) and xlstm-1.3b (batch 2) at
    full width and S 4096 on the card, under ``train_policy()`` (fake-quant
    ±1 weights with the XNOR-Net alpha), on random float32 params from a
    seeded generator and a batch of ``synthetic_lm_batches``.

    The launch counts are 0 just before the loss forward and read after
    it: smollm must launch ``flash_attention`` 32 times, xlstm
    ``mlstm_chunked`` 42 times, and nothing else. Every kernel call of that
    forward is held against its twin on its own inputs. The loss and the
    logits (``lm_forward``) are held to the same model run with the twins
    in place of the kernels: the loss within ``LM_LOSS_TOL``, the logits
    within ``LM_LOGIT_TOL`` where the case says so (see ``LM_CASES``), and
    with float32 activations the loss within ``LM_F32_LOSS_TOL`` and the
    logits within ``LM_F32_LOGIT_TOL``. Loss and logits come from one
    ``Model.loss`` (``captured_logits``). Where the bf16 logits are past
    ``LM_LOGIT_TOL``, diagnostics: the kernel path run again, and for the
    mLSTM the twin path with y one float32 ulp up. Prints the loss, the
    forward's ms (CUDA events), peak memory and a profile."""
    import dataclasses

    from repro_torch.configs.base import get_config, train_policy
    from repro_torch.data.pipeline import DataConfig, synthetic_lm_batches
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import mlstm_chunked_ref
    from repro_torch.models.model_factory import build_model

    def check(kernel):
        def held(label, args, kwargs, out):
            with torch.no_grad():
                if kernel == "flash_attention":
                    return flash_error(label, out, flash_twin(*args, **kwargs))
                return mlstm_error(label, out, mlstm_chunked_ref(*args, **kwargs))
        return held

    results = {}
    for arch, batch_size, kernel, per_forward, hold_bf16_logits in cases:
        if isinstance(arch, str):
            cfg = get_config(arch)
        else:
            cfg, arch = arch, arch.name
        policy = train_policy()
        model = build_model(cfg, policy)
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        batch = next(synthetic_lm_batches(DataConfig(
            seed=0, global_batch=batch_size, seq_len=seq,
            vocab_size=cfg.vocab_size)))
        batch = {"tokens": batch["tokens"].to(dev),
                 "labels": batch["labels"].to(dev)}
        res = {"config": {"name": cfg.name, "num_layers": cfg.num_layers,
                          "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
                          "dtype": str(cfg.dtype)},
               "batch": [batch_size, seq], "init_s": time.monotonic() - t0,
               "param_bytes": _nbytes(params)}

        def run(m):
            """(total, loss, logits) of one ``Model.loss``."""
            with torch.no_grad(), captured_logits() as kept:
                total, parts = m.loss(params, batch)
            return float(total), float(parts["loss"]), kept[0]

        with checked_calls(kernel, check(kernel)) as errors:
            ops.reset_launches()
            total, loss, logits_k = run(model)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
        want = {**dict.fromkeys(ops.LAUNCHES, 0), kernel: per_forward}
        if launches != want:
            fail(f"{arch} loss forward: launches {launches}, expected {want}")
        if len(errors) != per_forward or not np.isfinite(total):
            fail(f"{arch}: {len(errors)} {kernel} calls checked, loss {total}")
        res.update(launches=launches, loss=loss, total=total,
                   calls_checked=len(errors),
                   calls_max_abs_err=max(e["max_abs_err"] for e in errors))
        if kernel == "mlstm_chunked":
            res["calls_max_of_limit"] = max(e["max_of_limit"] for e in errors)
        if kernel == "flash_attention":
            res.update(calls_max_row_ulps=max(e["max_row_ulps"] for e in errors),
                       calls_max_elem_ulps=max(e["max_elem_ulps"] for e in errors),
                       calls_max_share_past_own_ulp=max(
                           e["elements_past_own_ulp"] / e["elements"] for e in errors))
        shape = (batch_size, seq, cfg.padded_vocab)
        if logits_k.shape != shape or not torch.isfinite(logits_k).all():
            fail(f"{arch}: logits {tuple(logits_k.shape)}, expected {shape}, "
                 f"finite={bool(torch.isfinite(logits_k).all())}")
        with twins_in_place():
            _, loss_t, logits_t = run(model)
        res.update(twin_loss=loss_t, loss_diff=abs(loss - loss_t),
                   logits=logit_diff(logits_k, logits_t, seq, LM_LOGIT_TOL))
        if res["logits"]["outside_tol"]:
            # Diagnostics of a bf16 gap past LM_LOGIT_TOL: the kernel path
            # again (run to run), and for the mLSTM the twin path with y one
            # float32 ulp up (the model's own sensitivity to an ulp of the
            # kernel's output).
            res["rerun_logits_max_abs_diff"] = float(
                (run(model)[2] - logits_k).abs().max())
            if kernel == "mlstm_chunked":
                def nudged(*args, **kwargs):
                    y, *rest = mlstm_chunked_ref(*args, **kwargs)
                    return (torch.nextafter(y, torch.full_like(y, float("inf"))),
                            *rest)
                with twins_in_place():
                    ops.mlstm_chunked = nudged
                    res["nudged_twin_logits"] = logit_diff(
                        run(model)[2], logits_t, seq, LM_LOGIT_TOL)
        del logits_k, logits_t
        model32 = build_model(dataclasses.replace(cfg, dtype=torch.float32), policy)
        _, f32_k, f32_logits_k = run(model32)
        with twins_in_place():
            _, f32_t, f32_logits_t = run(model32)
        res["f32_logits"] = logit_diff(f32_logits_k, f32_logits_t, seq,
                                       LM_F32_LOGIT_TOL)
        del f32_logits_k, f32_logits_t
        res.update(f32_loss=f32_k, f32_loss_diff=abs(f32_k - f32_t))
        lg = res["logits"]
        print(f"  {arch} ({cfg.num_layers} layers, d_model {cfg.d_model}, batch "
              f"{batch_size} x {seq}, params {res['param_bytes'] / 1e9:.2f} GB "
              f"float32): loss {loss:.6f} (total {total:.6f}); launched "
              f"{launches[kernel]} {kernel} and nothing else, every call within "
              f"{res['calls_max_abs_err']:.3g} of its twin"
              + (f" ({res['calls_max_row_ulps']:.2f} row ulps, "
                 f"{res['calls_max_elem_ulps']:.2f} own ulps, at most "
                 f"{res['calls_max_share_past_own_ulp']:.2e} of a call past one)"
                 if "calls_max_row_ulps" in res else "")
              + (f" ({res['calls_max_of_limit']:.2f} of the limit)"
                 if "calls_max_of_limit" in res else "")
              + f"; twin path loss {loss_t:.6f} (|diff| {res['loss_diff']:.3g}), "
              f"max |logit diff| {lg['max_abs_diff']:.3g} by position "
              f"{lg['by_position']} (|logits| up to {lg['abs_max']:.3g}, "
              f"{lg['outside_tol']} outside {LM_LOGIT_TOL}), argmax agree "
              f"{lg['argmax_agreement']:.4f}"
              + (f"; kernel path again: max |diff| "
                 f"{res['rerun_logits_max_abs_diff']:.3g}"
                 if "rerun_logits_max_abs_diff" in res else "")
              + (f"; twin path with y one ulp up: max |logit diff| "
                 f"{res['nudged_twin_logits']['max_abs_diff']:.3g} by position "
                 f"{res['nudged_twin_logits']['by_position']}"
                 if "nudged_twin_logits" in res else "")
              + f"; float32 activations: loss {f32_k:.6f}, kernel vs twin |diff| "
              f"{res['f32_loss_diff']:.3g}, max |logit diff| "
              f"{res['f32_logits']['max_abs_diff']:.3g} by position "
              f"{res['f32_logits']['by_position']} "
              f"({res['f32_logits']['outside_tol']} outside {LM_F32_LOGIT_TOL})",
              flush=True)
        if res["loss_diff"] > LM_LOSS_TOL or (hold_bf16_logits and lg["outside_tol"]):
            fail(f"{arch}: kernel vs twin path loss {loss} vs {loss_t}, "
                 f"{lg['outside_tol']} logits outside {LM_LOGIT_TOL}")
        if res["f32_loss_diff"] > LM_F32_LOSS_TOL or res["f32_logits"]["outside_tol"]:
            fail(f"{arch}: float32 activations, kernel vs twin loss {f32_k} vs "
                 f"{f32_t}, {res['f32_logits']['outside_tol']} logits outside "
                 f"{LM_F32_LOGIT_TOL}")
        del model32
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        res["loss_ms"] = events_ms(lambda: run(model), reps=2)
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        res["loss_breakdown"] = device_breakdown(lambda: run(model), top=8)
        print(f"    loss forward {res['loss_ms']:.1f} ms (CUDA events); "
              f"max_memory_allocated {res['max_memory_allocated'] / 1e9:.2f} GB; "
              f"profile: " + (res["loss_breakdown"]
                              if isinstance(res["loss_breakdown"], str) else ""),
              flush=True)
        if not isinstance(res["loss_breakdown"], str):
            for kname, ms, share in res["loss_breakdown"]:
                print(f"    {ms:10.3f} ms {share:6.1%}  {kname}", flush=True)
        results[arch] = res
        del params
    return results


KERNELS = {
    "xnor_gemm": ("src/repro_torch/kernels/csrc/xnor_gemm.cu",
                  "src/repro/kernels/xnor_gemm.py:105"),
    "fused_xnor_gemm": ("src/repro_torch/kernels/csrc/fused_gemm.cu",
                        "src/repro/kernels/fused_gemm.py:125"),
    "fused_direct_conv": ("src/repro_torch/kernels/csrc/direct_conv.cu",
                          "src/repro/kernels/direct_conv.py:171"),
    "megakernel_conv_stage": (
        "src/repro_torch/kernels/csrc/megakernel_conv_stage.cu",
        "src/repro/kernels/megakernel.py:339"),
    "megakernel_chain": ("src/repro_torch/kernels/csrc/megakernel_chain.cu",
                         "src/repro/kernels/megakernel.py:229"),
    "pack_rows": ("src/repro_torch/kernels/csrc/pack_rows.cu",
                  "src/repro/kernels/pack.py:44"),
    "direct_conv": ("src/repro_torch/kernels/csrc/direct_conv.cu",
                    "src/repro/kernels/direct_conv.py:235"),
    "unpack_gemm": ("src/repro_torch/kernels/csrc/unpack_gemm.cu",
                    "src/repro/kernels/unpack_gemm.py:74"),
    "ssm_scan_chunk": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                       "src/repro/kernels/ssm_scan.py:70"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:102"),
    "mlstm_chunked": ("src/repro_torch/kernels/csrc/mlstm_chunk.cu",
                      "src/repro/kernels/mlstm_chunk.py:112"),
}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--parent-src", default=None,
        help="directory holding the parent commit's " + ", ".join(
            f"{name}.cu" for name in PARENT_SOURCES) + " and the headers they "
             "include, timed beside the "
             "kernels (default: git show HEAD~1; not measured without either)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    try:
        from repro_torch.configs.bnn_cifar import BNNExperiment
        from repro_torch.kernels import build, ops
    except ImportError as err:
        fail(f"cannot import the port from {ROOT / 'src'}: {err}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    parent_procs = start_parent_build(args.parent_src)
    loop_procs = start_xnor_loop_build()
    info = build.build()
    parents = finish_parent_build(parent_procs)
    print(f"kernel build: {info['seconds']:.1f} s ({', '.join(info['built']) or 'cached'})"
          f" in {info['dir']}", flush=True)
    print("parent kernels: " + (", ".join(sorted(parents)) + f" built in {PARENT_DIR}"
                                if isinstance(parents, dict) else
                                f"not measured ({parents})"), flush=True)
    for name, log in info["ptxas"].items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")

    print("phase 3: the packed product's inner loops, then kernels vs plain "
          "twins at their main paths' shapes (bit-exact)", flush=True)
    xnor_loops = xnor_loop_rates(loop_procs)
    totals, rows = kernel_phase(dev)
    megakernel_phase(dev, totals, rows)
    # The Table 2 forward's own shapes (its batch) make the totals; the
    # batch-32 shapes are checked and timed beside them.
    unfused_kernel_phase(dev, totals, rows, BNNExperiment("table2").batch,
                         summed=True, parents=parents)
    unfused_kernel_phase(dev, totals, rows, BATCH, summed=False, parents=parents)
    unpack_decode_phase(dev, totals, rows)
    scan_phase(dev, totals, rows, parents)
    attention_phase(dev, totals, rows)
    print("phase 4: serving on the trained checkpoint", flush=True)
    serve = serve_phase(dev)
    print("phase 5: Table 2 on the card", flush=True)
    table2 = table2_phase(dev)
    print("phase 6: jamba-1.5-large-398b, one full-width period, served "
          "from 1-bit weights", flush=True)
    jamba = jamba_phase(dev)
    print("phase 7: LM training forward (Model.loss) at full width",
          flush=True)
    lm = lm_phase(dev)
    jamba_launches = dict(jamba["launches"]["prefill"])
    for counts in jamba["launches"]["decode"]:
        for name, n in counts.items():
            jamba_launches[name] += n
    launches = {**serve["launches"], **table2["launches"],
                "jamba_serve": jamba_launches,
                **{f"{arch}_loss": r["launches"] for arch, r in lm.items()}}
    for name in KERNELS:
        if not sum(path[name] for path in launches.values()):
            fail(f"kernel {name} was not launched on the main path")

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": info["seconds"], "xnor_loops": xnor_loops, "shapes": rows,
         "serve": serve,
         "table2": table2, "jamba": jamba, "lm_loss": lm, "totals": totals},
        indent=2))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = totals[name]
        t_bytes = t["bytes"] / HBM_BYTES_PER_S
        t_ops = t["ops"] / OPS_RATE.get(name, B1_OPS_PER_S)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(p[name] for p in launches.values()),
            "launches_by_path": {path: p[name] for path, p in launches.items()
                                 if p[name]},
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": t["library_ms"],
        })
        for extra in ("per_layer_ms", "real_input_max_abs_err",
                      "fp32_bound_ms", "tc_bound_ms", "parent_ms",
                      "library_bf16_ms"):
            if extra in t:
                kernels[-1][extra] = t[extra]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
