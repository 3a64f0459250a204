"""The scan backward's tunings and the cost of its parts, on one GPU.

    python3 scripts/scan_bwd_ablation.py [--reps N]

Builds variants of ``src/repro_torch/kernels/csrc/ssm_scan_bwd.cu`` and
times each beside the source as it stands, in turns (A B ... B A) on one
card, at the jamba chunk ([1, 256, 16384, 16], the operands as the
prefill hands them over) and at the smoke jamba's training shape ([8, 64,
256, 8]). Two kinds of variant:

- tunings (``TUNINGS``, edits of the width-16 line ``kBwd16`` and of the
  kernel's launch bounds): lanes a channel (G), steps a segment (K),
  channels a block, and the blocks an SM the registers must allow (with
  the shared memory, these set the warps an SM holds); each is held to
  the plain twin within
  ``chip_smoke.BWD_F32_TOL``, as ``chip_smoke.py`` holds the kernel;
- parts (``EDITS``): a ring of 3 or 4 staged segments in place of 2,
  every thread's 16-byte ``cp.async`` copies in place of one thread's
  tensor-map (TMA) copies,
  ``ex2.approx`` in place of ``expf`` (its error on every gradient is
  printed, not held to a tolerance), checkpoints for
  128 steps a block (a chunk of 256 steps then runs its forward pass one
  and a half times), and, timed only (their results are wrong), the
  forward pass to the checkpoints without its arithmetic, every exp
  replaced by its argument, and the reverse steps without the shuffles
  that sum over the warp's channels.

A variant that does not launch (more shared memory or registers than an
SM has) is reported as such.

Prints each variant's registers and spill bytes (ptxas), one line a
variant and shape, and writes ``build/scan_bwd_ablation.json``. Needs
CUDA and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402

OUT = ROOT / "build" / "scan_bwd_ablation"
SOURCE = build.CSRC / "ssm_scan_bwd.cu"
SYMBOL = "repro_ssm_scan_chunk_bwd"

_TUNING = "constexpr int kBwd16[3] = {4, 8, 64};"
_BLOCKS = "__launch_bounds__(CPB * G, 1)"


def _tuning(g: int, k: int, c: int, blocks: int) -> list:
    return [(_TUNING, f"constexpr int kBwd16[3] = {{{g}, {k}, {c}}};"),
            (_BLOCKS, f"__launch_bounds__(CPB * G, {blocks})")]


# {name: edits}: G lanes a channel, K steps a segment, channels a block,
# and the blocks an SM the registers must allow
TUNINGS = {f"G {g}, K {k}, {c} ch, {m} blk": _tuning(g, k, c, m)
           for g, k, c, m in ((2, 8, 64, 1), (8, 8, 64, 1), (8, 8, 32, 2), (4, 16, 64, 1),
                              (4, 8, 32, 1), (4, 8, 32, 2), (4, 16, 32, 1))}
EDITS = {
    "ex2.approx, not expf": [(
        "  return expf(__fmul_rn(dtv, a));",
        "  float e, x = __fmul_rn(__fmul_rn(dtv, a), 1.4426950408889634f);\n"
        "  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(e) : \"f\"(x));\n  return e;")],
    "3 stages": [("constexpr int kBwdStages = 2;", "constexpr int kBwdStages = 3;")],
    "4 stages": [("constexpr int kBwdStages = 2;", "constexpr int kBwdStages = 4;")],
    "copies by threads (cp.async)": [("  const bool tma = p.tma != 0;", "  const bool tma = false;")],
    "checkpoints for 128 steps": [("constexpr int kBwdSpan = 256;", "constexpr int kBwdSpan = 128;")],
    # parts taken away (wrong results, timed only)
    "no forward-pass arithmetic": [
        ("        advance<S, DS, K, CPB, true>(h, a, stage(sg), g, cl, tn);", ""),
        ("        advance<S, DS, K, CPB, false>(h, a, stage(sg), g, cl, tn);", "")],
    # the forward pass's cycles (thread 0 of each block, B 1): issuing the
    # copies, the checkpoint stores, the arithmetic
    "forward stamps": [
        ("  const int nseg = (C + K - 1) / K;\n  for (int span",
         "  long long z[6] = {0, 0, 0, 0, 0, 0}, zz;\n"
         "  const int nseg = (C + K - 1) / K;\n  for (int span"),
        ("      if (sn < seg1) issue(sn, false);\n      cp_async_commit();\n",
         "      zz = clock64();\n      if (sn < seg1) issue(sn, false);\n      cp_async_commit();\n"
         "      z[0] += clock64() - zz;\n      zz = clock64();\n"),
        ("      const int tn = min(K, C - sg * K);\n      if (tn == K) {\n        advance",
         "      z[1] += clock64() - zz;\n      zz = clock64();\n"
         "      const int tn = min(K, C - sg * K);\n      if (tn == K) {\n        advance"),
        ("        advance<S, DS, K, CPB, false>(h, a, stage(sg), g, cl, tn);\n      }\n    }\n",
         "        advance<S, DS, K, CPB, false>(h, a, stage(sg), g, cl, tn);\n      }\n"
         "      z[2] += clock64() - zz;\n    }\n"),
        ("  if (live) {\n    float* a_out",
         "  if (tid == 0 && p.batch == 1) {\n"
         "    for (int k = 0; k < 6; ++k) p.a_part[blockIdx.x * 8 + k] = static_cast<float>(z[k]);\n"
         "  }\n  if (live) {\n    float* a_out")],
    "no expf (da = dt A)": [("  return expf(__fmul_rn(dtv, a));", "  return __fmul_rn(dtv, a);")],
    # clock64 stamps of thread 0 of each block (B 1 only), written past the
    # scratch: cycles in all, in the forward pass, at the barrier of a
    # segment (its operands landed) in the forward and in the reverse pass,
    # in the segments' recompute and reverse steps, and in the block sums
    "phase stamps": [
        ("  const int nseg = (C + K - 1) / K;\n  for (int span",
         "  long long z0 = clock64(), z[6] = {0, 0, 0, 0, 0, 0}, zz;\n"
         "  const int nseg = (C + K - 1) / K;\n  for (int span"),
        ("      landed(sg);\n      const int sn = sg + kBwdStages - 1;",
         "      zz = clock64();\n      landed(sg);\n      z[2] += clock64() - zz;\n"
         "      const int sn = sg + kBwdStages - 1;"),
        ("    // reverse, segment by segment, last first;",
         "    z[1] += clock64() - z0;\n    // reverse, segment by segment, last first;"),
        ("      landed(sg);\n      const int sn = sg - (kBwdStages - 1);",
         "      zz = clock64();\n      landed(sg);\n      z[3] += clock64() - zz;\n"
         "      const int sn = sg - (kBwdStages - 1);"),
        ("      if (sg + 1 < seg1) {  // the segment after",
         "      zz = clock64();\n      if (sg + 1 < seg1) {  // the segment after"),
        ("      const int t0 = sg * K, tn = min(K, C - t0);\n",
         "      z[5] += clock64() - zz;\n      const int t0 = sg * K, tn = min(K, C - t0);\n"),
        ("      if (tn == K) {\n        reverse_segment",
         "      zz = clock64();\n      if (tn == K) {\n        reverse_segment"),
        ("      }\n    }\n    cp_async_wait<0>();\n    __syncthreads();  // the first segment's",
         "      }\n      z[4] += clock64() - zz;\n    }\n    cp_async_wait<0>();\n"
         "    __syncthreads();  // the first segment's"),
        ("  if (live) {\n    float* a_out",
         "  if (tid == 0 && p.batch == 1) {\n    z[0] = clock64() - z0;\n"
         "    for (int k = 0; k < 6; ++k) p.a_part[blockIdx.x * 8 + k] = static_cast<float>(z[k]);\n"
         "  }\n  if (live) {\n    float* a_out")],
    "no sums over channels": [("      transpose_sums<S::LANES, NS, 2 * NS>(v, lane);", "")],
}
SHAPES = [("jamba chunk", 1, 256, 16384, 16, 512), ("smoke jamba step", 8, 64, 256, 8, 64)]
NAMES = ("dt", "xh", "B", "C", "A", "h0")


def edited_sources() -> dict:
    """{name: the source's text}: as it stands, each tuning and each edit."""
    text = SOURCE.read_text()
    sources = {"as is": text}
    for name, edits in {**TUNINGS, **EDITS}.items():
        edited = text
        for old, new in edits:
            if old not in edited:
                raise SystemExit(f"edit {name!r}: text not found in {SOURCE.name}")
            edited = edited.replace(old, new)
        sources[name] = edited
    return sources


def compile_variants() -> dict:
    """{name: (built library, ptxas lines)}, all nvcc runs at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(edited_sources().items()):
        src, lib = OUT / f"v{i}.cu", OUT / f"v{i}.so"
        src.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} did not build:\n{log[-3000:]}")
        libs[name] = (lib, ptxas_lines(log))
    return libs


def ptxas_lines(log: str) -> list:
    """One line a kernel from ``ptxas -v``: its name, registers, spills."""
    out, name, spill = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            name = "sum" if "sum_kernel" in name else name[name.find("kernelI") + 7:].split("E")[0]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':')[-1].strip()}; {spill}")
    return out


def launcher(lib):
    """(the launcher, the scratch size query) of a variant's library."""
    dll = ctypes.CDLL(str(lib))
    fn = getattr(dll, SYMBOL)
    fn.argtypes = list(build._SIGNATURES[SYMBOL])
    fn.restype = ctypes.c_int
    size = getattr(dll, SYMBOL + "_scratch")
    size.argtypes = list(build._SIGNATURES[SYMBOL + "_scratch"])
    size.restype = ctypes.c_int
    return fn, size


def rel_errors(got, want) -> dict:
    """Each gradient's max abs error over its largest magnitude."""
    return {n: float((g - w).abs().max()) / (float(w.abs().max()) or 1.0)
            for n, g, w in zip(NAMES, got, want)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=2, help="A B ... B A rounds")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    libs = compile_variants()
    for name, (_, regs) in libs.items():
        for line in regs:
            print(f"{name:28s} {line}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(27)
    results = {"device": smi, "ptxas": {n: v[1] for n, v in libs.items()}, "shapes": {}}
    for label, b, c, di, ds, seq in SHAPES:
        ops_args = chip_smoke.scan_operands(gen, b, c, di, ds, seq, dev)
        dy = torch.randn((b, c, di), generator=gen, device=dev)
        dh_last = torch.randn((b, di, ds), generator=gen, device=dev)
        want = ref.ssm_scan_chunk_bwd_ref(*ops_args, dy, dh_last)
        f32 = dict(dtype=torch.float32, device=dev)
        grads = (torch.empty((b, c, di), **f32), torch.empty((b, c, di), **f32),
                 torch.empty((b, c, ds), **f32), torch.empty((b, c, ds), **f32),
                 torch.empty((di, ds), **f32), torch.empty((b, di, ds), **f32))
        dt, xh, bm, cm, a, h0 = ops_args
        runs, failed, scratches = {}, {}, {}
        for name, (lib, _) in libs.items():
            fn, size = launcher(lib)
            floats = (ctypes.c_longlong * 1)()
            if size(b, c, di, ds, floats):
                raise SystemExit(f"{name}: the scratch query failed")
            scratch = torch.zeros(floats[0] + 8 * -(-di // 16), **f32)  # and stamps
            scratches[name] = (scratch, floats[0])

            def run(fn=fn, scratch=scratch):
                rc = fn(*(t.data_ptr() for t in (dt, xh, bm, cm, a, h0, dy, dh_last)),
                        *(g.data_ptr() for g in grads), scratch.data_ptr(), b, c, di, ds,
                        dt.stride(0), dt.stride(1), xh.stride(0), xh.stride(1),
                        bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")
                return grads
            try:
                run()
            except RuntimeError as err:  # e.g. more shared memory than a block has
                failed[name] = f"did not launch: {err}"
                print(f"{label:16s} {name:28s} {failed[name]}", flush=True)
                continue
            runs[name] = run
        rows = {}
        for name, run in runs.items():
            got = [g.clone() for g in run()]
            rows[name] = {"ms": [], "max_rel_err": rel_errors(got, want)}
            if name == "as is" or name in TUNINGS:
                chip_smoke.grad_error("ssm_scan_chunk_bwd", f"{label} {name}", NAMES, got,
                                      want, torch.float32)
        order = list(runs)
        for _ in range(args.reps):
            for name in order + order[::-1]:
                rows[name]["ms"].append(chip_smoke.graph_ms(runs[name]))
        if "forward stamps" in runs and b == 1:
            runs["forward stamps"]()
            torch.cuda.synchronize()
            scratch, used = scratches["forward stamps"]
            nblk = -(-di // 64)
            z = scratch[used:used + 8 * nblk].view(nblk, 8)[:, :3].double().mean(0).tolist()
            rows["forward stamps"]["cycles_a_block"] = dict(zip(
                ("copies issued", "checkpoint stores", "arithmetic"), z))
            print(f"{label:16s} forward stamps, cycles a block: " + ", ".join(
                f"{k} {v:.0f}" for k, v in rows["forward stamps"]["cycles_a_block"].items()),
                flush=True)
        if "phase stamps" in runs and b == 1:
            runs["phase stamps"]()
            torch.cuda.synchronize()
            scratch, used = scratches["phase stamps"]
            nblk = -(-di // 64)
            z = scratch[used:used + 8 * nblk].view(nblk, 8)[:, :6]
            mean = z.double().mean(0).tolist()
            rows["phase stamps"]["cycles_a_block"] = dict(zip(
                ("all", "forward", "forward waits", "reverse waits", "segments",
                 "block sums"), mean))
            print(f"{label:16s} phase stamps, cycles a block (mean of {nblk}): " + ", ".join(
                f"{k} {v:.0f}" for k, v in rows["phase stamps"]["cycles_a_block"].items()),
                flush=True)
        for name, run in runs.items():
            ms = sorted(rows[name]["ms"])
            errs = rows[name]["max_rel_err"]
            print(f"{label:16s} {name:28s} {ms[len(ms) // 2]:.4f} ms (of {len(ms)}: "
                  f"{ms[0]:.4f}-{ms[-1]:.4f})  max |err| / max |grad| "
                  + ", ".join(f"d{n} {errs[n]:.2g}" for n in NAMES), flush=True)
        results["shapes"][label] = {**rows, **failed}
        del ops_args, dt, xh, bm, cm, a, h0, dy, dh_last, want, grads, runs
        torch.cuda.empty_cache()
    OUT.mkdir(parents=True, exist_ok=True)
    (ROOT / "build" / "scan_bwd_ablation.json").write_text(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
