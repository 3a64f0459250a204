"""``repro_torch.kernels.autotune``: the tilings a caller may ask for,
the heuristics ``AUTO`` falls back to, the persistent cache and its
stamp, and ``tune`` (mirroring ``tests/test_autotune.py`` of the JAX
package). CPU only: the wrappers validate a tiling here and their twins
compute the same integers whatever it is; the kernels' variants are
held to the twins on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import json

import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune, ops
from repro_torch.kernels.autotune import AUTO, BlockConfig

from torch_parity import t, words

SMS = 132  # the H100 SXM's SMs

STAMP = {"torch": "2.x-test", "cuda": "12.x-test", "device": "Test GPU"}


@pytest.fixture()
def cache_file(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    monkeypatch.setattr(autotune, "runtime_stamp", lambda: dict(STAMP))
    return path


# ------------------------------ heuristics ----------------------------------

# (M, KW, N, SMs) -> (tile_n, k_splits), worked out by hand from tile_n and
# tc_k_splits in csrc/xnor_tc.cuh: Table 2's eight batch-64 products, the
# served batch-32 fc0 and head, ragged ones, and a card of 8 SMs.
C_HEURISTIC = [
    ((128, 36, 65536, SMS), (128, 1)),    # conv1, 512 tiles of 128
    ((256, 36, 16384, SMS), (128, 1)),
    ((256, 72, 16384, SMS), (128, 1)),
    ((512, 72, 4096, SMS), (64, 1)),      # 128 tiles of 128 < 132 SMs
    ((512, 144, 4096, SMS), (64, 1)),
    ((1024, 256, 64, SMS), (64, 16)),     # fc0: 17 wanted, 16-word splits
    ((1024, 32, 64, SMS), (64, 1)),       # K of one slab
    ((10, 32, 64, SMS), (64, 1)),
    ((10, 32, 32, SMS), (32, 1)),         # the served head
    ((1024, 256, 32, SMS), (32, 16)),     # fc0 at batch 32
    ((1000, 250, 61, SMS), (64, 16)),
    ((300, 257, 33, SMS), (64, 33)),      # 8-word splits
    ((128, 100, 1024, 8), (128, 1)),      # 8 tiles fill 8 SMs
    ((128, 100, 256, 8), (64, 2)),        # 2 tiles of 128 < 8 SMs; 4 of 64
]


@pytest.mark.parametrize("shape,want", C_HEURISTIC)
def test_heuristics_match_the_c_launchers(shape, want):
    m, kw, n, sms = shape
    bn = autotune.heuristic_tile_n(m, n, sms)
    assert (bn, autotune.heuristic_k_splits(m, kw, n, sms)) == want
    assert autotune.resolve_gemm("xnor_gemm", m, kw, n, AUTO, AUTO, sms) == want
    assert autotune.k_splits_ok(kw, want[1])


def test_split_counts_leave_no_split_empty():
    assert autotune.split_words(256, 17) == 16
    assert autotune.k_splits_ok(256, 16) and not autotune.k_splits_ok(256, 17)
    assert autotune.k_splits_ok(36, 3) and not autotune.k_splits_ok(36, 4)
    assert not autotune.k_splits_ok(36, 0) and not autotune.k_splits_ok(36, 1.0)
    for kw in range(1, 300):
        for s in range(1, 40):
            if autotune.k_splits_ok(kw, s):
                sw = autotune.split_words(kw, s)
                assert (s - 1) * sw < kw <= s * sw


def test_chain_and_stage_heuristics():
    shape = autotune.stage_shape(32, 8, 8, 8, (16, 16), 3, 3, 1, True)
    assert autotune.resolve_stage_cluster(shape, AUTO) == 8
    assert autotune.resolve_stage_cluster(shape, 4) == 4
    assert autotune.heuristic_chain_clusters(1024) == (16, 8)   # the trunk
    assert autotune.heuristic_chain_clusters(96) == (1, 1)
    assert autotune.heuristic_chain_clusters(128) == (4, 4)


# ------------------------------ cache ----------------------------------------

def test_cache_round_trip(cache_file):
    cfg = BlockConfig(block_n=64, k_splits=4)
    shape = autotune.gemm_shape(1024, 256, 32)
    autotune.save_entry("fused_xnor_gemm", shape, cfg, wall_s=1e-5)
    assert cache_file.exists()
    assert autotune.load_entry("fused_xnor_gemm", shape) == cfg
    assert autotune.load_entry("fused_xnor_gemm", {**shape, "n": 64}) is None
    assert autotune.load_entry("xnor_gemm", shape) is None
    entry = json.loads(cache_file.read_text())["entries"][
        "fused_xnor_gemm|kw=256|m=1024|n=32"]
    assert entry["device"] == "Test GPU" and entry["wall_s"] == 1e-5
    # AUTO takes the entry field by field; explicit requests win
    assert autotune.resolve_gemm("fused_xnor_gemm", 1024, 256, 32, AUTO, AUTO,
                                 SMS) == (64, 4)
    assert autotune.resolve_gemm("fused_xnor_gemm", 1024, 256, 32, 128, AUTO,
                                 SMS) == (128, 4)


@pytest.mark.parametrize("field", ["torch", "cuda", "device"])
def test_cache_ignores_a_stale_stamp(cache_file, monkeypatch, field):
    """The invalidation guard: an entry measured under another torch, CUDA
    or device is never served."""
    cfg = BlockConfig(block_n=32)
    shape = autotune.gemm_shape(128, 8, 128)
    autotune.save_entry("xnor_gemm", shape, cfg)
    assert autotune.load_entry("xnor_gemm", shape) == cfg
    monkeypatch.setattr(autotune, "runtime_stamp",
                        lambda: {**STAMP, field: "other"})
    assert autotune.load_entry("xnor_gemm", shape) is None
    assert autotune.resolve_gemm("xnor_gemm", 128, 8, 128, AUTO, AUTO, SMS) == (
        autotune.heuristic_tile_n(128, 128, SMS), 1)


@pytest.mark.parametrize("content", [
    "not json {", '{"version": 1, "entries": []}', '{"version": 99, "entries": {}}',
    "[1, 2, 3]",
    '{"version": 1, "entries": {"xnor_gemm|kw=1|m=1|n=1": {"block_n": 96}}}'])
def test_cache_tolerates_garbage(cache_file, content):
    cache_file.write_text(content)
    shape = autotune.gemm_shape(1, 1, 1)
    assert autotune.load_entry("xnor_gemm", shape) is None
    assert autotune.resolve_gemm("xnor_gemm", 1, 1, 1, AUTO, AUTO, SMS) == (32, 1)
    autotune.save_entry("xnor_gemm", shape, BlockConfig(block_n=64))
    assert autotune.load_entry("xnor_gemm", shape) == BlockConfig(block_n=64)


def test_cache_survives_torn_write_and_leaves_no_temp(cache_file, monkeypatch):
    shape = autotune.gemm_shape(4, 4, 4)
    autotune.save_entry("xnor_gemm", shape, BlockConfig(block_n=32))
    before = cache_file.read_text()

    def torn(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(autotune.os, "replace", torn)
    with pytest.raises(OSError, match="disk full"):
        autotune.save_entry("xnor_gemm", {**shape, "n": 8}, BlockConfig(block_n=64))
    assert cache_file.read_text() == before
    assert sorted(p.name for p in cache_file.parent.iterdir()) == ["autotune.json"]
    assert autotune.load_entry("xnor_gemm", shape) == BlockConfig(block_n=32)


def test_cache_disabled_by_env(cache_file, monkeypatch):
    autotune.save_entry("xnor_gemm", autotune.gemm_shape(8, 8, 8),
                        BlockConfig(block_n=128))
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert not autotune.cache_enabled()
    assert autotune.resolve_gemm("xnor_gemm", 8, 8, 8, AUTO, AUTO, SMS) == (32, 1)


def test_default_cache_path_is_the_ports(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert autotune.cache_path() == tmp_path / "repro_torch" / "autotune.json"
    monkeypatch.delenv("XDG_CACHE_HOME")
    assert autotune.cache_path().parts[-3:] == (".cache", "repro_torch",
                                                "autotune.json")


def test_runtime_stamp_names_torch_cuda_and_device():
    stamp = autotune.runtime_stamp()
    assert stamp["torch"] == torch.__version__
    assert stamp["cuda"] == torch.version.cuda
    assert stamp["device"] == (torch.cuda.get_device_name()
                               if torch.cuda.is_available() else "cpu")


# ------------------------------ wrappers and tune ----------------------------

def test_wrappers_refuse_tilings_the_kernels_cannot_run():
    rng = np.random.default_rng(60)
    w, x = t(words(rng, (40, 36))), t(words(rng, (36, 5)))
    a, b = torch.ones(40), torch.zeros(40)
    xm, wc = t(words(rng, (1, 4, 4, 2))), t(words(rng, (40, 18)))
    for bad in (dict(tile_n=96), dict(tile_n=0), dict(k_splits=4),
                dict(k_splits=0)):
        with pytest.raises(ValueError):
            ops.xnor_gemm(w, x, 32 * 36, **bad)
        with pytest.raises(ValueError):
            ops.fused_xnor_gemm(w, x, 32 * 36, a, b, **bad)
    with pytest.raises(ValueError):
        ops.direct_conv(wc, xm, 576, kh=3, kw=3, pad=1, tile_n=48)
    with pytest.raises(ValueError):
        ops.fused_direct_conv(wc, xm, 576, a, b, kh=3, kw=3, pad=1, tile_n=48)
    with pytest.raises(ValueError, match="cluster"):
        ops.megakernel_conv_stage(xm, [wc], [a], [b], [576], cluster=16)
    stack = {"w": t(words(rng, (1, 64, 2))), "a": torch.ones(1, 64),
             "b": torch.zeros(1, 64)}
    with pytest.raises(ValueError, match="cluster"):
        ops.megakernel_chain(stack["w"], stack["a"], stack["b"], (64,),
                             t(words(rng, (2, 8))), 64, cluster=4)


def test_twins_ignore_a_valid_tiling():
    rng = np.random.default_rng(61)
    w, x = t(words(rng, (40, 36))), t(words(rng, (36, 5)))
    want = ops.xnor_gemm(w, x, 1152)
    for bn in autotune.TILE_NS:
        for s in (1, 2, 3):
            assert torch.equal(ops.xnor_gemm(w, x, 1152, tile_n=bn, k_splits=s),
                               want)


def test_tune_checks_bit_identity_then_caches_the_fastest(cache_file):
    """On the CPU the twins stand in for the kernel and a fake timer for
    the card: every candidate's output equals AUTO's, the fastest by the
    timer is returned and stored."""
    shape = autotune.gemm_shape(64, 96, 16)
    cands = [BlockConfig(block_n=bn, k_splits=s) for bn in (32, 64)
             for s in (1, 2)]
    fake = iter([5.0, 4.0, 3.0, 1.0, 2.0])   # AUTO, then the candidates
    timings = {}
    best = autotune.tune("fused_xnor_gemm", shape, cands, device="cpu",
                         timings=timings, timer=lambda fn: (fn(), next(fake))[1])
    assert best == BlockConfig(block_n=64, k_splits=1)
    assert timings[AUTO] == 5.0 and timings[best] == 1.0
    assert autotune.load_entry("fused_xnor_gemm", shape) == best
    assert autotune.resolve_gemm("fused_xnor_gemm", 64, 96, 16, AUTO, AUTO,
                                 SMS) == (64, 1)


def test_tune_refuses_a_tiling_that_changes_the_output(cache_file, monkeypatch):
    real = ops.xnor_gemm

    def wrong_at_64(wp, xp, k_bits, **kw):
        out = real(wp, xp, k_bits, **kw)
        return out + 1 if kw.get("tile_n") == 64 else out

    monkeypatch.setattr(ops, "xnor_gemm", wrong_at_64)
    with pytest.raises(RuntimeError, match="changed the output"):
        autotune.tune("xnor_gemm", autotune.gemm_shape(32, 4, 8),
                      [BlockConfig(block_n=32), BlockConfig(block_n=64)],
                      device="cpu", timer=lambda fn: 1.0)
    assert not cache_file.exists()


def test_tune_skips_candidates_the_kernel_refuses(cache_file):
    timings = {}
    best = autotune.tune("xnor_gemm", autotune.gemm_shape(32, 36, 8),
                         [BlockConfig(k_splits=4), BlockConfig(k_splits=3)],
                         device="cpu", timings=timings, timer=lambda fn: 1.0)
    assert best == BlockConfig(k_splits=3)
    assert timings[BlockConfig(k_splits=4)] is None


@pytest.mark.parametrize("kernel,shape", [
    ("xnor_gemm", autotune.gemm_shape(1024, 256, 32)),
    ("direct_conv", autotune.conv_shape(1, 8, 8, 4, 64, 3, 3, 1, 1)),
    ("megakernel_conv_stage", autotune.stage_shape(1, 4, 4, 4, (4, 8), 3, 3, 1,
                                                   True)),
    ("megakernel_chain", autotune.chain_shape((8, 2), 64, 8, 8, 10, 2, 8))])
def test_tune_operands_run_every_candidate_on_the_twins(kernel, shape):
    call = autotune.operands(kernel, shape, "cpu")
    want = call()
    cands = autotune.default_candidates(kernel, shape)
    assert cands and len(set(cands)) == len(cands)
    for cfg in cands:
        assert torch.equal(call(**autotune.block_kwargs(cfg, kernel)), want)
