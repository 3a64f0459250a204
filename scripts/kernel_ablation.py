"""Where the time of a hand-written kernel goes, on one GPU.

    python3 scripts/kernel_ablation.py [--reps N] [--only SOURCE ...]

No profiler here sees inside a kernel (``ncu`` does not run on the card's
host), so this script removes one part of a kernel at a time: it builds
variants of a source in ``src/repro_torch/kernels/csrc`` with textual
edits (``ABLATIONS``; most give wrong results and are only timed), and
times each beside the unedited source at the main path's shapes, in turns
(A B ... B A) on one card. A part's cost is the time it takes away (the
two conv kernels: the gather of the implicit patch matrix, the int32
stores of ``direct_conv_dot``, the ldmatrix B fragments, the exchange
through distributed shared memory; the scan: lanes a channel,
``ex2.approx`` against ``expf``). It
also measures the tensor cores' ``mma.sync`` rates: m16n8k16 bf16, the
ceiling of flash's and unpack_gemm's products, and m16n8k8 tf32, whose
third is the ceiling of the mLSTM's 3xTF32 products; and the latency of
one 1-bit m16n8k256 in a dependent chain. Prints one line per shape and writes
``build/kernel_ablation.json``. Needs CUDA and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

OUT = ROOT / "build" / "kernel_ablation"

# {source: {variant: [(old, new), ...]}}; a variant whose text is missing
# from the source is reported as not applicable.
ABLATIONS = {
    "flash_attention": {
        "p by __expf, not expf": [("p[i] = expf(", "p[i] = __expf(")],
        "no softmax on unmasked tiles (p = s)": [(
            """        online_softmax<kNt, false, true>(s, pf, scale, k0, t, row_a, row_b, Skv,
                                         causal, m_a, m_b, l_a, l_b, corr_a, corr_b);""",
            """        corr_a = corr_b = 1.f;
        for (int j = 0; j < kNt; ++j) {
          pf[j / 2][(j & 1) * 2] = pack_bf16x2(s[j][0], s[j][1]);
          pf[j / 2][(j & 1) * 2 + 1] = pack_bf16x2(s[j][2], s[j][3]);
        }""")],
    },
    "mlstm_chunk": {
        "1xTF32 (a_hi b_hi only)": [
            ("        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mp + m2][nt], al[m2], "
             "bh[nt][0], bh[nt][1]);", "        for (int nt = 0; nt < 0; ++nt) {}"),
            ("        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mp + m2][nt], ah[m2], "
             "bl[nt][0], bl[nt][1]);", "        for (int nt = 0; nt < 0; ++nt) {}")],
    },
    "direct_conv": {
        "no int32 stores (direct_conv_dot's epilogue)": [(
            "*reinterpret_cast<int4*>(dst) = dot;", "(void)dst;")],
        "gather as a contiguous load (no table, no border test)": [(
            """      const bool inside = static_cast<unsigned>(y0 + (e.y >> 16)) < static_cast<unsigned>(H) &&
                          static_cast<unsigned>(x0 + (e.y & 0xffff)) < static_cast<unsigned>(W);
      const unsigned* src = img + (off0 + e.x);""",
            """      const bool inside = true;
      const unsigned* src = img + min(max(off0, 0) + k, H * W - 1);""")],
    },
    "ssm_scan": {
        **{f"{g} lane{'s' if g > 1 else ''} a channel at ds 16": [(
            "err = launch<16, 2>(args, B, s);", f"err = launch<16, {g}>(args, B, s);")]
           for g in (1, 4, 8)},
        "ex2.approx, not expf": [("constexpr bool kScanEx2 = false;",
                                  "constexpr bool kScanEx2 = true;")],
        "dt, x loaded 2 groups ahead, not 4": [("constexpr int kScanLoads = 4;",
                                                "constexpr int kScanLoads = 2;")],
    },
    "megakernel_conv_stage": {
        "B by 4-byte loads, not ldmatrix": [(
            "if (c.cw % 4 == 0) {\n    unit_counts<true>",
            "if (false) {\n    unit_counts<true>")],
        "DSMEM exchange as local writes": [(
            "*cluster.map_shared_rank(cell, g) = word;",
            "if (g == 0) *cell = word;")],
        "filters not staged (no cp.async of W)": [(
            "cp_async16(dst, k < K ? from : wg, k < K ? 16 : 0);", "(void)from;")],
        "no products (K loop skipped)": [(
            "for (int kk = 0; kk < K; kk += 8) {", "for (int kk = 0; kk < 0; kk += 8) {")],
    },
    "unpack_gemm": {
        "no Kahan (plain +=)": [(
            """            const float y = __fsub_rn(part[mt][j][i], comp[mt][j][i]);
            const float sum = __fadd_rn(acc[mt][j][i], y);
            comp[mt][j][i] = __fsub_rn(__fsub_rn(sum, acc[mt][j][i]), y);
            acc[mt][j][i] = sum;""",
            "            acc[mt][j][i] += part[mt][j][i];")],
        "no weight unpack": [("for (int j = 0; j < 2; ++j) {\n      const int job",
                              "for (int j = 0; j < 0; ++j) {\n      const int job")],
        "no X conversion": [(
            "for (int j = 0; j < kPairs / kUgThreads; ++j) {\n      int n, k;",
            "for (int j = 0; j < 0; ++j) {\n      int n, k;")],
        "no tensor-core loop": [("if (rows_live && n_live > 0) {",
                                 "if (rows_live && n_live > 4) {")],
    },
}

MMA_BENCH = r"""
#include <cuda_runtime.h>
#include <cstdint>
// iters x 16 independent m16n8k16 bf16 products per warp.
__global__ void hmma_loop(float* out, int iters) {
  float c[16][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7;
  const uint32_t b0 = a0 ^ 0x3f803f80u, b1 = b0 + 1;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_hmma(float* out, int blocks, int threads, int iters) {
  hmma_loop<<<blocks, threads>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
// iters x 16 independent m16n8k8 tf32 products per warp.
__global__ void tmma_loop(float* out, int iters) {
  float c[16][4] = {};
  const uint32_t a0 = threadIdx.x << 13, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7;
  const uint32_t b0 = 0x3f800000u, b1 = b0 + (1u << 13);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_tmma(float* out, int blocks, int threads, int iters) {
  tmma_loop<<<blocks, threads>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
// iters dependent 1-bit m16n8k256 and.popc products (one accumulator): the
// latency of one, when a warp runs alone.
__global__ void b1_chain(float* out, int iters) {
  int c[4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7;
  const uint32_t b0 = a0 ^ 0x5555u, b1 = a0 ^ 0xa5a5u;
  for (int it = 0; it < iters; ++it) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  out[threadIdx.x] = static_cast<float>(c[0] + c[1] + c[2] + c[3]);
}
extern "C" int run_b1_chain(float* out, int iters) {
  b1_chain<<<1, 32>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def compile_variants(sources) -> dict:
    """``{(source, variant): .so path or None}`` for the ``sources`` of
    ``ABLATIONS``, every nvcc in parallel (variant "as is" is the unedited
    source)."""
    procs, libs = {}, {}
    for source, variants in ABLATIONS.items():
        if source not in sources:
            continue
        text = (build.CSRC / f"{source}.cu").read_text()
        for variant, edits in {"as is": [], **variants}.items():
            edited = text
            if any(old not in edited for old, _ in edits):
                libs[(source, variant)] = None
                continue
            for old, new in edits:
                edited = edited.replace(old, new)
            d = OUT / source / str(len(procs))
            d.mkdir(parents=True, exist_ok=True)
            for header in build.CSRC.glob("*.cuh"):
                shutil.copy(header, d / header.name)
            (d / f"{source}.cu").write_text(edited)
            procs[(source, variant)] = (d / "lib.so", subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                 str(d / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for key, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key} did not build:\n{log[-3000:]}")
        libs[key] = path
    return libs


def launcher(path, symbol: str):
    fn = getattr(ctypes.CDLL(str(path)), symbol)
    fn.argtypes = list(build._SIGNATURES[symbol])
    fn.restype = ctypes.c_int
    return fn


def flash_cases(dev):
    gen = torch.Generator(device=dev).manual_seed(15)
    bh, s, dh = 60, 4096, 64
    q, k, v = (torch.randn((bh, s, dh), generator=gen, device=dev).bfloat16()
               for _ in range(3))
    out = torch.empty_like(q)

    def make(path):
        fn = launcher(path, "repro_flash_attention")
        return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          bh, s, s, dh, 1, 1, dh ** -0.5,
                          torch.cuda.current_stream().cuda_stream)
    return [(f"smollm layer [{bh},{s},{dh}] bf16", make)]


def unpack_cases(dev):
    """Table 2's batch-64 binary layers that dominate (±1 input, the
    transposed activations) and jamba's decode shape (bf16)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    cpu = torch.Generator().manual_seed(3)
    cases = []
    for label, k, n, m, dtype in [("conv1 b64", 1152, 65536, 128, torch.float32),
                                  ("conv3 b64", 2304, 16384, 256, torch.float32),
                                  ("conv5 b64", 4608, 4096, 512, torch.float32),
                                  ("fc0 b64", 8192, 64, 1024, torch.float32),
                                  ("jamba decode", 8192, 4, 8192, torch.bfloat16)]:
        x2d = torch.rand((n, k), generator=gen, device=dev) * 2 - 1
        x = (torch.sign(x2d) + (x2d == 0).float()).to(dtype).T
        wp = chip_smoke.rand_words(cpu, (m, k // 32), dev)

        def make(path, wp=wp, x=x, m=m, k=k, n=n, dtype=dtype):
            fn = launcher(path, "repro_unpack_gemm")
            splits = launcher(path, "repro_unpack_gemm_splits")(m, k // 32, n)
            scratch = torch.empty((splits, m, n), device=dev) if splits > 1 else None
            out = torch.empty((m, n), device=dev)
            return lambda: fn(wp.data_ptr(), x.data_ptr(), out.data_ptr(),
                              None if scratch is None else scratch.data_ptr(), m,
                              k // 32, n, x.stride(0), x.stride(1),
                              int(dtype == torch.bfloat16), splits,
                              torch.cuda.current_stream().cuda_stream)
        cases.append((f"{label} [{m},{k}]x[{k},{n}]", make))
    return cases


def direct_conv_cases(dev):
    """The five convs of Table 2's DIRECT_KERNEL forward at its batch of
    64 through ``direct_conv_dot`` (int32 out), then the five of the
    batch-32 served forward through the fused kernel (3x3, stride 1, pad
    1)."""
    cpu = torch.Generator().manual_seed(18)
    cases = []
    batch = 64
    for label, h, c, d in chip_smoke.conv_cases():
        cw, k_bits = c // 32, 9 * c
        x = chip_smoke.rand_words(cpu, (batch, h, h, cw), dev)
        w = chip_smoke.rand_words(cpu, (d, 9 * cw), dev)
        out = torch.empty((batch, h, h, d), dtype=torch.int32, device=dev)

        def make(path, x=x, w=w, out=out, h=h, cw=cw, d=d, k_bits=k_bits):
            fn = launcher(path, "repro_direct_conv_dot")
            return lambda: fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), batch, h, h,
                              cw, d, 3, 3, 1, 1, k_bits,
                              torch.cuda.current_stream().cuda_stream)
        cases.append((f"dot {label} b{batch}", make))
    for label, h, c, d in chip_smoke.conv_cases():
        cw, k_bits = c // 32, 9 * c
        x = chip_smoke.rand_words(cpu, (chip_smoke.BATCH, h, h, cw), dev)
        w = chip_smoke.rand_words(cpu, (d, 9 * cw), dev)
        a, b = chip_smoke.rand_affine(cpu, d, k_bits, dev)
        out = torch.empty((chip_smoke.BATCH, h, h, d // 32), dtype=torch.int32,
                          device=dev)

        def make(path, x=x, w=w, a=a, b=b, out=out, h=h, cw=cw, d=d, k_bits=k_bits):
            fn = launcher(path, "repro_fused_direct_conv")
            return lambda: fn(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                              out.data_ptr(), chip_smoke.BATCH, h, h, cw, d, 3, 3, 1,
                              1, k_bits, torch.cuda.current_stream().cuda_stream)
        cases.append((f"fused {label} b{chip_smoke.BATCH}", make))
    return cases


def scan_cases(dev):
    """The jamba prefill's chunk (4, 256, 16384, 16), read in place as
    ``chip_smoke.scan_operands`` hands it over."""
    gen = torch.Generator(device=dev).manual_seed(14)
    label, b, c, di, ds, seq = chip_smoke.SCAN_CASES[0]
    dt, xh, bm, cm, a, h0 = chip_smoke.scan_operands(gen, b, c, di, ds, seq, dev)
    y = torch.empty((b, c, di), device=dev)
    h_last = torch.empty((b, di, ds), device=dev)

    def make(path):
        fn = launcher(path, "repro_ssm_scan_chunk")
        return lambda: fn(dt.data_ptr(), xh.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                          a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                          b, c, di, ds, dt.stride(0), dt.stride(1), xh.stride(0),
                          xh.stride(1), bm.stride(0), bm.stride(1), cm.stride(0),
                          cm.stride(1), torch.cuda.current_stream().cuda_stream)
    return [(f"{label} [{b},{c},{di},{ds}]", make)]


def conv_stage_cases(dev):
    """The three conv stages of the batch-32 forward."""
    from repro_torch.kernels import ops

    cpu = torch.Generator().manual_seed(19)
    cases = []
    for label, h, chans in chip_smoke.STAGE_CASES:
        x, ws, a, b, k_bits = chip_smoke.stage_operands(cpu, h, chans,
                                                        chip_smoke.BATCH, dev)
        d_words = [wl.shape[0] // 32 for wl in ws]
        args = (ops._ptrs(ws), ops._ptrs(a), ops._ptrs(b), ops._ints(d_words),
                ops._ints([chans[0] // 32] + d_words[:-1]), ops._ints(k_bits))
        out = torch.empty((chip_smoke.BATCH, h // 2, h // 2, d_words[-1]),
                          dtype=torch.int32, device=dev)

        def make(path, x=x, out=out, args=args, h=h, n_layers=len(ws),
                 cluster=8, keep=(ws, a, b)):
            # (`keep`: the tensors behind the pointer arrays stay alive)
            fn = launcher(path, "repro_megakernel_conv_stage")
            return lambda: fn(x.data_ptr(), out.data_ptr(), *args, n_layers,
                              chip_smoke.BATCH, h + 2, h + 2, 3, 3, 1, 1, cluster,
                              torch.cuda.current_stream().cuda_stream)
        cases.append((f"{label} b{chip_smoke.BATCH}", make))
    return cases


# Where a conv-stage CTA's time goes: globaltimer stamps (thread 0 of
# each CTA) at the phase boundaries of megakernel_conv_stage.cu, inserted
# as text: 0 start, 1 staging issued, 2 past the first cluster barrier,
# then for conv l: 3 + 2l its filters landed and P(w) counted, 4 + 2l its
# units done; 11 end.
def _stamp(slot: str) -> str:
    return ("if (threadIdx.x == 0) { unsigned long long t_; asm volatile("
            f'"mov.u64 %0, %%globaltimer;" : "=l"(t_)); g_ts[blockIdx.x * 12 + ({slot})]'
            " = t_; }\n")


TIMELINE_EDITS = [
    ("namespace repro_torch {\n\nconstexpr int kStageMaxLayers",
     "__device__ unsigned long long g_ts[4096 * 12];\n"
     'extern "C" void* ts_ptr() { void* p; cudaGetSymbolAddress(&p, g_ts); return p; }\n'
     "namespace repro_torch {\n\nconstexpr int kStageMaxLayers"),
    ("  const StageLayout L = stage_layout(p);\n",
     "  const StageLayout L = stage_layout(p);\n" + _stamp("0")),
    ("  cluster.sync();\n\n  int hin = p.hp;",
     _stamp("1") + "  cluster.sync();\n" + _stamp("2") + "\n  int hin = p.hp;"),
    ("    __syncthreads();  // P(w) is readable\n",
     "    __syncthreads();  // P(w) is readable\n" + _stamp("3 + 2 * l")),
    ("    if (!c.last || parts > 1) {\n      cluster.sync();",
     _stamp("4 + 2 * l") + "    if (!c.last || parts > 1) {\n      cluster.sync();"),
    ("    win = c.nxt_w;\n  }\n}", "    win = c.nxt_w;\n  }\n" + _stamp("11") + "}"),
]


def stage_timeline(dev) -> dict:
    """Median time since its start at which a CTA of each main-path stage
    reaches each phase boundary, the spread of CTA start times, and the
    launch's span (one call at batch 32, after warm-up)."""
    import numpy as np

    from repro_torch.kernels import ops

    src = (build.CSRC / "megakernel_conv_stage.cu").read_text()
    for old, new in TIMELINE_EDITS:
        if old not in src:
            return {"error": f"timeline anchor missing: {old[:40]!r}"}
        src = src.replace(old, new)
    d = OUT / "timeline"
    d.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    (d / "stage.cu").write_text(src)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                    str(d / "stage.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "lib.so"))
    lib.ts_ptr.restype = ctypes.c_void_p
    copy = ctypes.CDLL("libcuda.so.1").cuMemcpyDtoH_v2
    copy.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_size_t]
    result = {}
    for (label, make), (_, h, chans) in zip(conv_stage_cases(dev), chip_smoke.STAGE_CASES):
        run = make(d / "lib.so")
        run()
        torch.cuda.synchronize()
        n_ctas = chip_smoke.BATCH * 8
        host = np.zeros(n_ctas * 12, dtype=np.uint64)
        if copy(host.ctypes.data, lib.ts_ptr(), host.nbytes):
            return {"error": "cuMemcpyDtoH failed"}
        ts = host.reshape(n_ctas, 12).astype(np.int64)
        rel = (ts - ts[:, :1].min()) / 1e3
        slots = [0, 1, 2] + list(range(3, 3 + 2 * (len(chans) - 1))) + [11]
        row = {"span_us": float(rel[:, 11].max()),
               "start_us_quantiles": [float(q) for q in np.quantile(
                   rel[:, 0], [0, 0.5, 0.9, 1.0])],
               "median_us_since_start": {s_: float(np.median(rel[:, s_] - rel[:, 0]))
                                         for s_ in slots}}
        result[label] = row
        print(f"  megakernel_conv_stage timeline {label}: span {row['span_us']:.1f} us, "
              f"CTA starts (0/50/90/100%) " + " ".join(
                  f"{q:.1f}" for q in row["start_us_quantiles"]) + " us; median since "
              "start: " + ", ".join(f"{s_}: {v:.1f}" for s_, v in
                                     row["median_us_since_start"].items()) + " us",
              flush=True)
    return result


def mlstm_cases(dev):
    """xlstm-1.3b's training shape, [8, 4096, 1024, 1024] chunk 256."""
    gen = torch.Generator(device=dev).manual_seed(15)
    bh, s, dk, dv, ln = 8, 4096, 1024, 1024, 256
    nc = s // ln
    q, k = (torch.randn((bh, s, dk), generator=gen, device=dev) for _ in range(2))
    v = torch.randn((bh, s, dv), generator=gen, device=dev)
    logi = torch.randn((bh, s), generator=gen, device=dev)
    logf = torch.nn.functional.logsigmoid(torch.randn((bh, s), generator=gen, device=dev) + 2)
    f32 = dict(dtype=torch.float32, device=dev)
    bufs = [torch.empty(shape, **f32) for shape in (
        (bh, s, dv), (bh, dk, dv), (bh, dk), (bh,), (bh, nc, ln, ln), (bh, s), (bh, s),
        (bh, s), (bh, s), (bh, nc), (bh, nc, 2), (bh, nc - 1, dk, dv), (bh, nc - 1, dk))]

    def make(path):
        fn = launcher(path, "repro_mlstm_chunked")
        return lambda: fn(*(t.data_ptr() for t in (q, k, v, logi, logf, *bufs)),
                          bh, s, ln, dk, dv, torch.cuda.current_stream().cuda_stream)
    return [(f"xlstm layer [{bh},{s},{dk},{dv}] L{ln}", make)]


def mma_rate() -> list:
    d = OUT / "mma"
    d.mkdir(parents=True, exist_ok=True)
    (d / "mma.cu").write_text(MMA_BENCH)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / "mma.so"),
                    str(d / "mma.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "mma.so"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 2 * 512, device="cuda")
    rows = []
    # (launcher, shape, k of one mma)
    for fn, what, k in ((lib.run_hmma, "m16n8k16 bf16", 16),
                        (lib.run_tmma, "m16n8k8 tf32", 8)):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        for blocks, threads in [(sms, 128), (sms, 256), (2 * sms, 256)]:
            iters = 4096
            fn(out.data_ptr(), blocks, threads, iters)
            ms = chip_smoke.time_ms(lambda: fn(out.data_ptr(), blocks, threads,  # noqa: B023
                                               iters), iters=1)
            flops = blocks * threads // 32 * iters * 16 * 2 * 16 * 8 * k
            rows.append({"mma": what, "blocks": blocks, "threads": threads,
                         "ms": ms, "tflops": flops / ms / 1e9})
            print(f"  mma.sync {what}, {blocks} blocks x {threads} threads: "
                  f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    lib.run_b1_chain.argtypes = [ctypes.c_void_p, ctypes.c_int]
    iters = 1 << 16
    ms = chip_smoke.time_ms(lambda: lib.run_b1_chain(out.data_ptr(), iters), iters=1)
    rows.append({"mma": "m16n8k256 b1 and.popc, one dependent chain", "ns_each": ms * 1e6 / iters})
    print(f"  mma.sync m16n8k256 b1 and.popc, one warp, dependent: {ms * 1e6 / iters:.1f} ns "
          "each", flush=True)
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=2,
                        help="turns per variant (A B ... B A counts 2)")
    parser.add_argument("--only", nargs="*", default=None, metavar="SOURCE",
                        help="ablate only these sources (default: all), and "
                             "skip the mma rates and the stage timeline")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_ablation: needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    sources = {"direct_conv": direct_conv_cases, "ssm_scan": scan_cases,
               "megakernel_conv_stage": conv_stage_cases,
               "flash_attention": flash_cases, "unpack_gemm": unpack_cases,
               "mlstm_chunk": mlstm_cases}
    if args.only is not None:
        sources = {k: v for k, v in sources.items() if k in args.only}
    libs = compile_variants(sources)
    result = {"device": smi, "kernels": {}}
    if args.only is None:
        result["mma_sync"] = mma_rate()
        result["conv_stage_timeline"] = stage_timeline(dev)
    for source, cases in sources.items():
        cases = cases(dev)
        variants = [v for (s, v) in libs if s == source]
        result["kernels"][source] = {}
        for label, make in cases:
            runs = {v: make(libs[(source, v)]) for v in variants if libs[(source, v)]}
            times = {v: [] for v in runs}
            order = list(runs)
            for turn in range(args.reps):
                for v in (order if turn % 2 == 0 else order[::-1]):
                    times[v].append(chip_smoke.graph_ms(runs[v]))
            row = {v: sum(t) / len(t) for v, t in times.items()}
            row.update({v: None for v in variants if v not in runs})
            result["kernels"][source][label] = row
            base = row["as is"]
            print(f"  {source} {label}: as is {base:.4f} ms; " + "; ".join(
                f"{v} {'not applicable' if t is None else f'{t:.4f} ms ({base - t:+.4f})'}"
                for v, t in row.items() if v != "as is"), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (ROOT / "build" / "kernel_ablation.json").write_text(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
