"""The flash attention backward's tunings and the cost of its parts, on one GPU.

    python3 scripts/flash_bwd_ablation.py [--reps N]

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
and times each beside the source as it stands, in turns (A B ... B A) on
one card, at smollm-360m's training shape (bf16 [60, 4096, 64], causal)
and at a head width of 128 ([16, 4096, 128]), with each variant's time
split by kernel (dK/dV, dQ, the row statistics). Two kinds of variant:

- tunings (``TUNINGS``, edits of its two constants): the streamed tiles
  in flight (``kWgStages``) and the blocks an SM must hold
  (``kMinBlocks``, which caps the registers); each is held to the plain
  twin, as ``chip_smoke.py`` holds the kernel;
- parts taken away or put back by textual edits (``EDITS``; their results
  are wrong and only timed): ``expf`` in place of ``ex2.approx``, p
  computed by an fma alone (no MUFU op), the copies' addresses worked out
  for each chunk as the first design did (not once a block), no copies
  after the ring's first tiles.

Prints one line a variant and shape and writes
``build/flash_bwd_ablation.json``. Needs CUDA and ``nvcc``; imports no
JAX.
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
from repro_torch.kernels import build, ops, ref  # noqa: E402

OUT = ROOT / "build" / "flash_bwd_ablation"
SOURCE = build.CSRC / "flash_attention_bwd.cu"
SYMBOL = "repro_flash_attention_bwd"

_STAGES = "constexpr int kWgStages = 2;"
_BLOCKS = "constexpr int kMinBlocks = DH <= 64 ? 3 : 1;"


def _tuning(stages: int, blocks: int) -> list:
    return [(_STAGES, f"constexpr int kWgStages = {stages};"),
            (_BLOCKS, f"constexpr int kMinBlocks = {blocks};")]


# {name: edits}: the source's tunings (stages, blocks an SM at every Dh)
TUNINGS = {f"stages {st}, {bl} block{'s' if bl > 1 else ''}": _tuning(st, bl)
           for st, bl in ((3, 1), (2, 1), (4, 1), (3, 2), (2, 2), (2, 3))}
_EXP_DKDV = "float p = ex2(fmaf(s_t[4 * j + e], c2, -((e & 1) ? l2.y : l2.x)));"
_EXP_DQ = "float p = ex2(fmaf(s[4 * j + e], c2, -l2[e >> 1]));"
# {name: [(text, replacement), ...]} on the source as it stands
EDITS = {
    "expf, not ex2.approx": [
        (_EXP_DKDV, "float p = expf(__fsub_rn(__fmul_rn(s_t[4 * j + e], scale), "
                    "__fmul_rn((e & 1) ? l2.y : l2.x, 0.6931471805599453f)));"),
        (_EXP_DQ, "float p = expf(__fsub_rn(__fmul_rn(s[4 * j + e], scale), "
                  "__fmul_rn(l2[e >> 1], 0.6931471805599453f)));")],
    "no MUFU op (p = the fma)": [
        (_EXP_DKDV, "float p = fmaf(s_t[4 * j + e], c2, -((e & 1) ? l2.y : l2.x));"),
        (_EXP_DQ, "float p = fmaf(s[4 * j + e], c2, -l2[e >> 1]);")],
    "copy addresses a chunk": [
        ("    stream.load(tq, q + qoff, q0, Sq);\n"
         "    stream.load(tq + Cfg::kTile, dout + qoff, q0, Sq);",
         "    Tl::stage(tq, q + qoff, q0, Sq, kQt, tid, 128);\n"
         "    Tl::stage(tq + Cfg::kTile, dout + qoff, q0, Sq, kQt, tid, 128);"),
        ("    stream.load(tk, k + koff, it * kKt, Skv);\n"
         "    stream.load(tk + Cfg::kTile, v + koff, it * kKt, Skv);",
         "    Tl::stage(tk, k + koff, it * kKt, Skv, kKt, tid, 128);\n"
         "    Tl::stage(tk + Cfg::kTile, v + koff, it * kKt, Skv, kKt, tid, 128);")],
    "no copies after the first tiles": [
        ("    if (it + kWgStages - 1 < steps) load(it + kWgStages - 1);",
         "    if (it + kWgStages - 1 < 0) load(it + kWgStages - 1);")],
}
SHAPES = [("smollm layer", 60, 4096, 64), ("dh 128", 16, 4096, 128)]


def edited_sources() -> dict:
    """{name: the source's text}: as it stands, each tuning and each edit."""
    text = SOURCE.read_text()
    sources = {"as is": text}
    for name, edits in {**TUNINGS, **EDITS}.items():
        edited = text
        for old, new in edits:   # every occurrence (the dK/dV and dQ kernels')
            if old not in edited:
                raise SystemExit(f"edit {name!r}: text not found in {SOURCE.name}")
            edited = edited.replace(old, new)
        sources[name] = edited
    return sources


def compile_variants() -> dict:
    """{name: (built library, ptxas register lines)}, all nvcc runs at once."""
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
        regs = [line.split(":")[-1].strip() for line in log.splitlines()
                if "Used" in line and "registers" in line]
        libs[name] = (lib, regs)
    return libs


def launcher(lib):
    fn = getattr(ctypes.CDLL(str(lib)), SYMBOL)
    fn.argtypes = list(build._SIGNATURES[SYMBOL])
    fn.restype = ctypes.c_int
    return fn


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
    gen = torch.Generator(device=dev).manual_seed(26)
    results = {"device": smi, "shapes": {}}
    for label, bh, s, dh in SHAPES:
        q, k, v, do = (torch.randn((bh, s, dh), generator=gen, device=dev).bfloat16()
                       for _ in range(4))
        o, lse = ops._flash_forward(q, k, v, True)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
        stats = torch.empty((2, bh, -(-s // 128) * 128), dtype=torch.float32, device=dev)
        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        runs = {}
        for name, (lib, _) in libs.items():
            fn = launcher(lib)

            def run(fn=fn):
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        lse.data_ptr(), do.data_ptr(), stats.data_ptr(),
                        *(g.data_ptr() for g in grads), bh, s, s, dh, 1, 1, dh ** -0.5,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"launch failed: CUDA error {rc}")
                return grads
            runs[name] = run
        rows = {}
        for name, run in runs.items():
            rows[name] = {"registers": libs[name][1], "ms": []}
            if name == "as is" or name in TUNINGS:
                err = chip_smoke.grad_error("flash_attention_bwd", f"{label} {name}", "qkv",
                                            [g.clone() for g in run()], want, torch.bfloat16)
                rows[name]["max_rel_err"] = max(err[f"{n}_rel"] for n in "qkv")
        order = list(runs)
        for _ in range(args.reps):
            for name in order + order[::-1]:
                rows[name]["ms"].append(chip_smoke.graph_ms(runs[name]))
        for name, run in runs.items():
            split = chip_smoke.device_breakdown(run, top=3)
            rows[name]["kernels"] = split if isinstance(split, str) else {
                n.split("(")[0].split("<")[0].split("::")[-1]: ms for n, ms, _ in split[:-1]}
            ms = sorted(rows[name]["ms"])
            print(f"{label:12s} {name:32s} {ms[len(ms) // 2]:.4f} ms (of {len(ms)}: "
                  f"{ms[0]:.4f}-{ms[-1]:.4f})  " + (
                      ", ".join(f"{n} {t:.3f}" for n, t in rows[name]["kernels"].items())
                      if isinstance(rows[name]["kernels"], dict) else rows[name]["kernels"])
                  + ("" if "max_rel_err" not in rows[name]
                     else f"  max |err| / max |grad| {rows[name]['max_rel_err']:.2g}"),
                  flush=True)
        results["shapes"][label] = rows
        del q, k, v, do, o, lse, want, stats, grads
        torch.cuda.empty_cache()
    OUT.mkdir(parents=True, exist_ok=True)
    (ROOT / "build" / "flash_bwd_ablation.json").write_text(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
