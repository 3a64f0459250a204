"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), torch and CUDA versions.
2. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. Runs each kernel at every shape the served CIFAR BNN gives it at
   batch 32 and holds its output, bit for bit, against its plain-torch
   twin on the same inputs; times kernel, twin and a PyTorch library
   yardstick (fp32 ``torch.matmul`` / ``F.conv2d`` of the unpacked ±1
   operands, TF32 off) with CUDA events.
4. Serves 12 ragged requests (1-8 images) through ``ServingEngine
   (engine="xnor")`` for each ``conv_impl`` on the trained checkpoint
   ``tests/golden/bnn_trained_ckpt.npz``, and holds every request's
   logits, bit for bit, against the ``xla`` (plain-torch) forward of
   the same images on the card. The launch counters are reset just
   before each ``conv_impl``'s engine is built and read just after its
   drain: each path must have launched exactly its own kernels, once
   per layer per forward (warmup and served batches), and no engine
   failover may be recorded.
5. Prints a ``{"kernels": [...]}`` line, then ``{"ok": true, ...}`` last.

Exits non-zero, with no result line, when CUDA is unavailable or any
phase fails. Per-shape details go to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and int8
# tensor-core ops/s — the fastest integer rate the card publishes, used
# as the rate of the ±1 multiply-adds (2 ops each).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
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


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events (median), so no host
    dispatch gap between launches is counted."""
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


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
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
        err = check_equal("fused_direct_conv", label, run(), twin())
        # Yardstick: F.conv2d of the ±1 map, pre-padded with +1 (the
        # binary border), and the ±1 filters, NCHW, TF32 off.
        xf = torch.nn.functional.pad(
            bitops.unpack_bits(x, axis=-1).permute(0, 3, 1, 2), (1, 1, 1, 1),
            value=1.0).contiguous()
        wf = bitops.unpack_bits(w, axis=-1).reshape(d, 3, 3, c).permute(
            0, 3, 1, 2).contiguous()
        lib = lambda: torch.nn.functional.conv2d(xf, wf)  # noqa: E731
        nbytes = (x.numel() + w.numel() + BATCH * h * h * (d // 32)) * 4 + 8 * d
        ops_n = 2 * BATCH * h * h * d * k_bits
        rows.append(record(totals["fused_direct_conv"], "fused_direct_conv",
                           label, err, run, twin, lib, nbytes, ops_n))
    return totals, rows


def record(total: dict, name: str, label: str, err: int, run, twin, lib,
           nbytes: int, ops_n: int) -> dict:
    ms = graph_ms(run)
    eager_ms = time_ms(run, iters=50)
    plain_ms = time_ms(twin, iters=2, reps=3)
    library_ms = graph_ms(lib, iters=5)
    bms, by = bound_ms(nbytes, ops_n)
    row = {"kernel": name, "shape": label, "max_abs_err": err, "ms": ms,
           "eager_ms": eager_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
           "bytes": nbytes, "ops": ops_n}
    print(f"  {name:18s} {label:14s} exact  kernel {ms:.4f} ms (eager call "
          f"{eager_ms:.4f})  plain {plain_ms:.3f} ms  library "
          f"{library_ms:.4f} ms  bound {bms:.5f} ms ({by})", flush=True)
    for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
        total[k] += row[k]
    total["bytes"] += nbytes
    total["ops"] += ops_n
    total["max_abs_err"] = max(total["max_abs_err"], err)
    return row


def launches_per_forward(conv_impl: str) -> dict:
    """Kernel launches one forward of the served BNN makes: one per
    binary conv (direct conv, or the im2col GEMM), one fused GEMM per
    hidden FC, one xnor_gemm for the head."""
    from repro_torch.core.bnn import CONV_CHANNELS, FC_SIZES

    convs, hidden_fc = len(CONV_CHANNELS) - 1, len(FC_SIZES) - 1
    direct = conv_impl == "direct"
    return {"xnor_gemm": 1,
            "fused_xnor_gemm": hidden_fc + (0 if direct else convs),
            "fused_direct_conv": convs if direct else 0}


def serve_phase(dev) -> dict:
    from repro_torch.core.bnn import (bnn_apply_fused, first_conv_packed,
                                      load_binary_checkpoint,
                                      pack_bnn_params_fused)
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_bnn import random_requests
    from repro_torch.serve import ServingEngine, is_error

    packed = pack_bnn_params_fused(load_binary_checkpoint(CKPT, device=dev))
    rng = np.random.default_rng(0)
    requests = random_requests(rng, count=12, max_images=8)
    result = {"requests": len(requests),
              "images": sum(r.shape[0] for r in requests)}

    engines, launches = {}, {}
    for conv_impl in ("direct", "im2col"):
        # This path's counts: 0 just before its engine is built, read
        # just after its drain.
        ops.reset_launches()
        t0 = time.monotonic()
        # max_wait 0: every step dispatches what is queued, so the
        # ragged requests reach several buckets.
        eng = ServingEngine(packed, engine="xnor", conv_impl=conv_impl,
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
        launches[conv_impl] = dict(ops.LAUNCHES)
        engines[conv_impl] = (eng, [eng.take(r) for r in rids])
        result[f"{conv_impl}_warmup_s"] = t1 - t0
        result[f"{conv_impl}_serve_s"] = t2 - t1
    result["launches"] = launches

    for conv_impl, (eng, got) in engines.items():
        snap = eng.snapshot()
        # Every warmed bucket ran one forward, then every served batch.
        forwards = len(eng.batcher.buckets) + snap["batches"]["dispatched"]
        expected = {k: v * forwards
                    for k, v in launches_per_forward(conv_impl).items()}
        if launches[conv_impl] != expected:
            fail(f"{conv_impl}: kernel launches {launches[conv_impl]} over "
                 f"{forwards} forwards, expected {expected}")
        if snap["dispatch"]["fallbacks"] or snap["degraded"]:
            fail(f"{conv_impl}: engine failover recorded: "
                 f"{snap['dispatch']['engine_path']}")
        if snap["requests"]["completed"] != len(requests):
            fail(f"{conv_impl}: {snap['requests']['completed']} of "
                 f"{len(requests)} requests completed")
        for i, (imgs, logits) in enumerate(zip(requests, got)):
            if logits is None or is_error(logits):
                fail(f"{conv_impl}: request {i} has no logits: {logits}")
            with torch.inference_mode():
                want = bnn_apply_fused(packed, torch.from_numpy(imgs).to(dev),
                                       engine="xla",
                                       conv_impl=conv_impl).cpu().numpy()
            if logits.shape != (imgs.shape[0], 10) or not np.isfinite(logits).all():
                fail(f"{conv_impl}: request {i} logits {logits.shape}, finite="
                     f"{np.isfinite(logits).all()}")
            if not np.array_equal(logits, want):
                fail(f"{conv_impl}: request {i}: served xnor logits differ "
                     f"from the xla forward (max abs "
                     f"{np.abs(logits - want).max()})")
        print(f"  serve xnor/{conv_impl}: {len(requests)} requests "
              f"({result['images']} images) bit-identical to xla; warmup "
              f"{result[f'{conv_impl}_warmup_s']:.3f} s, serve "
              f"{result[f'{conv_impl}_serve_s']:.3f} s, buckets "
              f"{snap['batches']['per_bucket']}", flush=True)
        print(f"  launches on the {conv_impl} path ({forwards} forwards): "
              f"{launches[conv_impl]}", flush=True)
    for name in ops.LAUNCHES:
        if not sum(path[name] for path in launches.values()):
            fail(f"kernel {name} was not launched on the main path")

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
                                  ("xla", "direct")):
            fwd = lambda: bnn_apply_fused(  # noqa: E731
                packed, x32, engine=engine, conv_impl=conv_impl)  # noqa: B023
            ms = time_ms(fwd, iters=10 if engine == "xnor" else 1, reps=3)
            result[f"forward_b32_{engine}_{conv_impl}_ms"] = ms
            line = f"  forward batch {BATCH} {engine}/{conv_impl}: {ms:.3f} ms"
            if engine == "xnor":
                gms = graph_ms(fwd, iters=5)
                result[f"forward_b32_{engine}_{conv_impl}_graph_ms"] = gms
                line += f" eager, {gms:.3f} ms replayed from a CUDA graph"
            print(line, flush=True)
        fc = lambda: first_conv_packed(packed, x32)  # noqa: E731
        result["first_conv_b32_ms"] = time_ms(fc, iters=10, reps=3)
        result["first_conv_b32_graph_ms"] = graph_ms(fc, iters=5)
        print(f"  first conv + BN + pack, batch {BATCH}: "
              f"{result['first_conv_b32_ms']:.3f} ms eager, "
              f"{result['first_conv_b32_graph_ms']:.3f} ms graph", flush=True)
    return result


KERNELS = {
    "xnor_gemm": ("src/repro_torch/kernels/csrc/xnor_gemm.cu",
                  "src/repro/kernels/xnor_gemm.py:105"),
    "fused_xnor_gemm": ("src/repro_torch/kernels/csrc/fused_gemm.cu",
                        "src/repro/kernels/fused_gemm.py:125"),
    "fused_direct_conv": ("src/repro_torch/kernels/csrc/direct_conv.cu",
                          "src/repro/kernels/direct_conv.py:171"),
}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    try:
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

    info = build.build()
    print(f"kernel build: {info['seconds']:.1f} s ({', '.join(info['built']) or 'cached'})"
          f" in {info['dir']}", flush=True)
    for name, log in info["ptxas"].items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")

    print(f"phase 3: kernels vs plain twins at batch {BATCH} (bit-exact)", flush=True)
    totals, rows = kernel_phase(dev)
    print("phase 4: serving on the trained checkpoint", flush=True)
    serve = serve_phase(dev)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": info["seconds"], "shapes": rows, "serve": serve,
         "totals": totals}, indent=2))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = totals[name]
        t_bytes, t_ops = t["bytes"] / HBM_BYTES_PER_S, t["ops"] / INT8_OPS_PER_S
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(p[name] for p in serve["launches"].values()),
            "launches_by_path": {impl: p[name] for impl, p
                                 in serve["launches"].items()},
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
