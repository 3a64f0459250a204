"""Where the time of a hand-written kernel goes, on one GPU.

    python3 scripts/kernel_ablation.py [--reps N]

No profiler here sees inside a kernel (``ncu`` does not run on the card's
host), so this script removes one part of a kernel at a time: it builds
variants of a source in ``src/repro_torch/kernels/csrc`` with textual
edits (``ABLATIONS``; most give wrong results and are only timed), and
times each beside the unedited source at the main path's shapes, in turns
(A B ... B A) on one card. A part's cost is the time it takes away. It
also measures the tensor cores' ``mma.sync`` rates: m16n8k16 bf16, the
ceiling of flash's and unpack_gemm's products, and m16n8k8 tf32, whose
third is the ceiling of the mLSTM's 3xTF32 products. Prints one line per shape and writes
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
"""


def compile_variants() -> dict:
    """``{(source, variant): .so path or None}``, every nvcc in parallel
    (variant "as is" is the unedited source)."""
    procs, libs = {}, {}
    for source, variants in ABLATIONS.items():
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
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=2,
                        help="turns per variant (A B ... B A counts 2)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_ablation: needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    libs = compile_variants()
    result = {"device": smi, "mma_sync": mma_rate(), "kernels": {}}
    for source, cases in (("flash_attention", flash_cases(dev)),
                          ("unpack_gemm", unpack_cases(dev)),
                          ("mlstm_chunk", mlstm_cases(dev))):
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
