"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), torch and CUDA versions.
2. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. Runs each kernel at every shape the served CIFAR BNN gives it at
   batch 32 and holds its output, bit for bit, against its plain-torch
   twin on the same inputs; times kernel, twin and a PyTorch library
   yardstick (fp32 ``torch.matmul`` / ``F.conv2d`` of the unpacked ±1
   operands, TF32 off) with CUDA events. The two megakernels run at the
   three conv-stage shapes (and once more at batch 3) and at the FC
   trunk (batch 32 and masked tails of 1, 3 and 13 columns); beside
   them the slice-1 per-layer kernels over the same layers are timed.
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
           nbytes: int, ops_n: int, per_layer=None, summed: bool = True) -> dict:
    """Time one main-path shape: kernel (graph replay and eager call),
    twin, library yardstick and, for a megakernel, the slice-1
    per-layer kernels over the same layers (``per_layer``). The kernel's
    totals sum the times of the batch-32 forward's shapes only
    (``summed``); every shape's error counts."""
    ms = graph_ms(run)
    eager_ms = time_ms(run, iters=50)
    plain_ms = time_ms(twin, iters=2, reps=3)
    library_ms = graph_ms(lib, iters=5)
    bms, by = bound_ms(nbytes, ops_n)
    row = {"kernel": name, "shape": label, "max_abs_err": err, "ms": ms,
           "eager_ms": eager_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
           "bytes": nbytes, "ops": ops_n}
    line = (f"  {name:21s} {label:18s} exact  kernel {ms:.4f} ms (eager call "
            f"{eager_ms:.4f})  plain {plain_ms:.3f} ms  library "
            f"{library_ms:.4f} ms  bound {bms:.5f} ms ({by})")
    if per_layer is not None:
        row["per_layer_ms"] = graph_ms(per_layer)
        line += f"  per-layer kernels {row['per_layer_ms']:.4f} ms"
    print(line, flush=True)
    total["max_abs_err"] = max(total["max_abs_err"], err)
    if not summed:
        return row
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "per_layer_ms"):
        if k in row:
            total[k] = total.get(k, 0.0) + row[k]
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
    twins, timed beside the per-layer kernels and a library chain."""
    from repro_torch.core import bitops
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(1)
    F = torch.nn.functional
    for label, h, chans in STAGE_CASES:
        for n in (3, BATCH):
            x, ws, a, b, k_bits = stage_operands(gen, h, chans, n, dev)
            run = lambda: ops.megakernel_conv_stage(x, ws, a, b, k_bits)  # noqa: E731,B023
            twin = lambda: bitops.conv_stage_xla(x, ws, a, b, k_bits)  # noqa: E731,B023
            err = check_equal("megakernel_conv_stage", f"{label} b{n}", run(),
                              twin())
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

            out_words = n * (h // 2) ** 2 * chans[-1] // 32
            nbytes = (x.numel() + sum(wl.numel() for wl in ws) + out_words) * 4
            nbytes += 8 * sum(chans[1:])
            ops_n = 2 * n * h * h * sum(d * k for d, k in zip(chans[1:], k_bits))
            rows.append(record(totals["megakernel_conv_stage"],
                               "megakernel_conv_stage", label, err, run, twin,
                               lib, nbytes, ops_n, per_layer=per_layer))

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


def launches_per_forward(path: str) -> dict:
    """Kernel launches one forward of the served BNN makes on ``path``:
    ``direct``/``im2col`` (the per-layer ``xnor`` engine) one per binary
    conv (direct conv, or the im2col GEMM), one fused GEMM per hidden
    FC, one xnor_gemm for the head; ``megakernel`` one launch per conv
    stage and one for the FC trunk."""
    from repro_torch.core.bnn import CONV_CHANNELS, CONV_STAGES, FC_SIZES

    if path == "megakernel":
        return {"xnor_gemm": 0, "fused_xnor_gemm": 0, "fused_direct_conv": 0,
                "megakernel_conv_stage": len(CONV_STAGES),
                "megakernel_chain": 1}
    convs, hidden_fc = len(CONV_CHANNELS) - 1, len(FC_SIZES) - 1
    direct = path == "direct"
    return {"xnor_gemm": 1,
            "fused_xnor_gemm": hidden_fc + (0 if direct else convs),
            "fused_direct_conv": convs if direct else 0,
            "megakernel_conv_stage": 0, "megakernel_chain": 0}


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
    megakernel_phase(dev, totals, rows)
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
        if "per_layer_ms" in t:
            kernels[-1]["per_layer_ms"] = t["per_layer_ms"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
