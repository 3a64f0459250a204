"""Tilings of the CUDA kernels: what a caller may ask for, what ``AUTO``
resolves to, and a tuner that measures the choices and remembers the
fastest (the port of ``repro.kernels.autotune``).

The JAX package sizes Pallas blocks against the TPU's VMEM. The port's
kernels compile a few tilings each, and a launch picks one:

* the 1-bit tensor-core tile (``csrc/xnor_tc.cuh``) of ``xnor_gemm``,
  ``fused_xnor_gemm``, ``fused_direct_conv`` and ``direct_conv`` is
  ``kTcBM`` = 128 rows x ``BN`` columns, ``BN`` in 32, 64 or 128
  (``BlockConfig.block_n``), over 32-word K slabs (``block_kw``);
* the two GEMMs also split K over ``k_splits`` blocks where the tiles
  cannot fill the card (``BlockConfig.k_splits``: a field of its own,
  not the JAX package's ``word_group``);
* ``megakernel_conv_stage`` runs a thread-block cluster of 1, 2, 4 or 8
  CTAs an image (``stage_cluster``), ``megakernel_chain`` one of a
  power of two up to 16 CTAs that divides its rows (``chain_cluster``).

``block_m`` is always 128 and ``block_kw`` 32: other values are refused,
as is any tiling of ``unpack_gemm`` and ``pack_rows`` (their split-K
order is the float sum order, so they keep the compiled one). Every
tiling a kernel accepts computes the same integer counts: outputs are
bit-identical, only time differs.

``AUTO`` resolves, field by field, to the tuned cache entry of the
launch's shape, else to the heuristic the C launchers use
(:func:`heuristic_tile_n`, :func:`heuristic_k_splits`; the chain's
cluster asks the card, ``ops._chain_cluster``). :func:`tune` times a
kernel's candidates with CUDA events, after holding each one's output to
the ``AUTO`` output bit for bit, and stores the fastest in a JSON cache:
``$REPRO_AUTOTUNE_CACHE`` if set, else ``$XDG_CACHE_HOME/repro_torch/
autotune.json``, else ``~/.cache/repro_torch/autotune.json`` (never the
JAX package's file). ``REPRO_AUTOTUNE=0`` bypasses the cache. Each entry
is stamped with ``torch.__version__``, ``torch.version.cuda`` and the
device name (:func:`runtime_stamp`), and an entry whose stamp differs
from the running one is ignored.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import statistics
import tempfile
from typing import Callable, Iterable, Optional, Union

import torch

AUTO = "auto"
CACHE_VERSION = 1

TC_BLOCK_M = 128            # kTcBM of csrc/xnor_tc.cuh
TC_SLAB_WORDS = 32          # kTcSlab: K words a pipeline stage
TILE_NS = (32, 64, 128)     # the compiled TcTile<BN> widths
STAGE_CLUSTERS = (1, 2, 4, 8)
# The conv stage's heuristic cluster: the portable maximum, 8 CTAs an
# image (channel groups of gcd(8, D/32)).
STAGE_CLUSTER_AUTO = 8
CHAIN_CLUSTERS = (1, 2, 4, 8, 16)
MAX_K_SPLITS = 65535        # the grid's z extent
# K above this many words, and fewer output tiles than this, before the
# heuristic splits K (tc_k_splits).
_SPLIT_MIN_WORDS = 2 * TC_SLAB_WORDS
_SPLIT_MAX_TILES = 32

Knob = Union[int, str]

# The BlockConfig fields each kernel reads, and the keyword of its
# ``kernels.ops`` wrapper. ``unpack_gemm`` and ``pack_rows`` read none.
KERNEL_KNOBS = {
    "xnor_gemm": {"block_n": "tile_n", "k_splits": "k_splits"},
    "fused_xnor_gemm": {"block_n": "tile_n", "k_splits": "k_splits"},
    "fused_direct_conv": {"block_n": "tile_n"},
    "direct_conv": {"block_n": "tile_n"},
    "megakernel_conv_stage": {"stage_cluster": "cluster"},
    "megakernel_chain": {"chain_cluster": "cluster"},
    "unpack_gemm": {},
    "pack_rows": {},
}
_TUNED_FIELDS = ("block_n", "k_splits", "stage_cluster", "chain_cluster")


def _is_auto(v) -> bool:
    return isinstance(v, str) and v == AUTO


def check_tile_n(tile_n: Knob) -> None:
    if not _is_auto(tile_n) and tile_n not in TILE_NS:
        raise ValueError(f"tile_n must be {AUTO!r} or one of {TILE_NS} (the "
                         f"compiled TcTile widths), got {tile_n!r}")


def split_words(kw: int, splits: int) -> int:
    """Each split's width in words: ``tc_split_words``, K shared out and
    rounded up to whole 8-word mma steps."""
    return ((-(-kw // splits)) + 7) & ~7 if splits > 1 else kw


def k_splits_ok(kw: int, splits) -> bool:
    """``tc_splits_ok``: 1, or a count whose rounded widths leave no split
    empty (and that the grid holds)."""
    if isinstance(splits, bool) or not isinstance(splits, int):
        return False
    if splits == 1:
        return True
    if splits < 1 or splits > MAX_K_SPLITS or kw < 1:
        return False
    return -(-kw // split_words(kw, splits)) == splits


def check_k_splits(kw: int, k_splits: Knob) -> None:
    if not _is_auto(k_splits) and not k_splits_ok(kw, k_splits):
        raise ValueError(f"k_splits={k_splits!r} cannot split {kw} K words "
                         "(each split takes whole 8-word steps and none may "
                         "be empty)")


def check_stage_cluster(cluster: Knob) -> None:
    if not _is_auto(cluster) and cluster not in STAGE_CLUSTERS:
        raise ValueError(f"the conv stage's cluster must be {AUTO!r} or one "
                         f"of {STAGE_CLUSTERS}, got {cluster!r}")


def check_chain_cluster(cluster: Knob, m_max: int) -> None:
    if _is_auto(cluster):
        return
    m_words = m_max // 32
    if cluster not in CHAIN_CLUSTERS or m_words % cluster:
        raise ValueError(f"the chain's cluster must be {AUTO!r} or one of "
                         f"{CHAIN_CLUSTERS} dividing M_max/32 = {m_words}, "
                         f"got {cluster!r}")


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One tiling request for every kernel of a forward; each kernel
    reads its own fields (``KERNEL_KNOBS``) and ``AUTO`` fields resolve
    per launch. ``block_m`` and ``block_kw`` name the tile's fixed rows
    and K slab and take no other value."""

    block_m: int = TC_BLOCK_M
    block_n: Knob = AUTO
    block_kw: int = TC_SLAB_WORDS
    k_splits: Knob = AUTO
    stage_cluster: Knob = AUTO
    chain_cluster: Knob = AUTO

    def __post_init__(self):
        if self.block_m != TC_BLOCK_M or self.block_kw != TC_SLAB_WORDS:
            raise ValueError(
                f"the tensor-core tile has block_m {TC_BLOCK_M} and block_kw "
                f"{TC_SLAB_WORDS}; got block_m={self.block_m}, "
                f"block_kw={self.block_kw}")
        check_tile_n(self.block_n)
        if not _is_auto(self.k_splits) and (
                not isinstance(self.k_splits, int) or self.k_splits < 1):
            raise ValueError(f"k_splits must be {AUTO!r} or >= 1, got "
                             f"{self.k_splits!r}")
        check_stage_cluster(self.stage_cluster)
        if not _is_auto(self.chain_cluster) and (
                self.chain_cluster not in CHAIN_CLUSTERS):
            raise ValueError(f"chain_cluster must be {AUTO!r} or one of "
                             f"{CHAIN_CLUSTERS}, got {self.chain_cluster!r}")

    def fields(self) -> dict:
        return {f: getattr(self, f) for f in _TUNED_FIELDS}

    def key(self) -> str:
        """A stable string of the requested fields (``"auto"`` for none),
        for cache keys and logs."""
        short = {"block_n": "bn", "k_splits": "ks", "stage_cluster": "sc",
                 "chain_cluster": "cc"}
        parts = [f"{short[f]}{v}" for f, v in self.fields().items()
                 if not _is_auto(v)]
        return "-".join(parts) or AUTO


def blocks_key(blocks) -> str:
    """Cache-key fragment of a ``blocks`` value (``"auto"`` or a
    :class:`BlockConfig`)."""
    if _is_auto(blocks):
        return AUTO
    if isinstance(blocks, BlockConfig):
        return blocks.key()
    raise TypeError(f"blocks must be {AUTO!r} or a BlockConfig, got {blocks!r}")


def block_kwargs(blocks, kernel: str) -> dict:
    """Keyword arguments of ``kernel``'s ``kernels.ops`` wrapper for a
    ``blocks`` value: the fields the kernel reads, ``AUTO`` ones left
    out. ``unpack_gemm`` and ``pack_rows`` keep their compiled tilings
    and raise for a config that requests any field."""
    if kernel not in KERNEL_KNOBS:
        raise ValueError(f"no kernel {kernel!r}; expected one of "
                         f"{sorted(KERNEL_KNOBS)}")
    if _is_auto(blocks):
        return {}
    if not isinstance(blocks, BlockConfig):
        raise ValueError(f"blocks must be {AUTO!r} or a BlockConfig, got "
                         f"{blocks!r}")
    knobs = KERNEL_KNOBS[kernel]
    asked = {f: v for f, v in blocks.fields().items() if not _is_auto(v)}
    if not knobs and asked:
        raise ValueError(f"{kernel} compiles one tiling (its split K is the "
                         f"float sum order); it takes no {sorted(asked)}")
    return {knobs[f]: v for f, v in asked.items() if f in knobs}


# ---------------------------------------------------------------------------
# Heuristics: the C launchers' choice, in Python
# ---------------------------------------------------------------------------

def heuristic_tile_n(m: int, n: int, sms: int) -> int:
    """``tile_n`` of ``csrc/xnor_tc.cuh``: 32 columns for N <= 32, else
    128, or 64 where 128-wide tiles would not give every SM one."""
    if n <= 32:
        return 32
    tiles = -(-m // TC_BLOCK_M) * -(-n // 128)
    return 128 if tiles >= sms else 64


def heuristic_k_splits(m: int, kw: int, n: int, sms: int, *,
                       tile_n: Optional[int] = None) -> int:
    """``tc_k_splits``: 1 where there are more than 32 output tiles or K
    is at most two slabs, else enough splits to fill the SMs once (at
    most one a K step), the count the rounded widths really give.
    ``tile_n``: the launch's tile width (default the heuristic's)."""
    bn = heuristic_tile_n(m, n, sms) if tile_n is None else tile_n
    tiles = -(-m // TC_BLOCK_M) * -(-n // bn)
    if tiles > _SPLIT_MAX_TILES or kw <= _SPLIT_MIN_WORDS:
        return 1
    splits = min(-(-sms // tiles), -(-kw // 8))
    if splits <= 1:
        return 1
    return -(-kw // split_words(kw, splits))


def heuristic_chain_clusters(m_max: int) -> tuple[int, int]:
    """The chain's (preferred, fallback) clusters: gcd(16, M_max/32) CTAs
    where the card holds one such cluster, else gcd(8, M_max/32)."""
    m_words = m_max // 32
    return math.gcd(16, m_words), math.gcd(8, m_words)


# ---------------------------------------------------------------------------
# The persistent cache
# ---------------------------------------------------------------------------

def cache_enabled() -> bool:
    return os.environ.get("REPRO_AUTOTUNE", "1") != "0"


def cache_path() -> pathlib.Path:
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return pathlib.Path(env)
    base = os.environ.get("XDG_CACHE_HOME")
    root = pathlib.Path(base) if base else pathlib.Path.home() / ".cache"
    return root / "repro_torch" / "autotune.json"


def runtime_stamp() -> dict:
    """What an entry must have been measured under to be served: the
    torch and CUDA versions and the name of the current device
    (``"cpu"`` without CUDA)."""
    device = torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": device}


def _entry_key(kernel: str, shape: dict) -> str:
    return "|".join([kernel] + [f"{k}={shape[k]}" for k in sorted(shape)])


# Parsed cache files by (path, mtime_ns, size): AUTO resolution reads the
# cache at every launch, and a stat is much cheaper than a parse.
_read_memo: dict = {}


def _load_raw(path: Optional[pathlib.Path] = None) -> dict:
    path = path or cache_path()
    empty = {"version": CACHE_VERSION, "entries": {}}
    try:
        stat = path.stat()
        memo_key = (str(path), stat.st_mtime_ns, stat.st_size)
        cached = _read_memo.get(memo_key)
        if cached is not None:
            return cached
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        return empty
    if (not isinstance(data, dict) or data.get("version") != CACHE_VERSION
            or not isinstance(data.get("entries"), dict)):
        data = empty  # a malformed file is ignored and replaced on save
    _read_memo.clear()
    _read_memo[memo_key] = data
    return data


def save_entry(kernel: str, shape: dict, config: BlockConfig, *,
               wall_s: Optional[float] = None,
               path: Optional[pathlib.Path] = None) -> None:
    """Store one tuned config, stamped with :func:`runtime_stamp`. The
    file is replaced atomically: a unique temp file in the same
    directory, flushed and synced, then ``os.replace``, so a reader sees
    the old cache or the new one and a crash leaves at most a stray temp
    file."""
    path = path or cache_path()
    _tuned_memo.clear()
    data = json.loads(json.dumps(_load_raw(path)))   # never edit the memo
    entry = {**runtime_stamp(), **config.fields()}
    if wall_s is not None:
        entry["wall_s"] = wall_s
    data["entries"][_entry_key(kernel, shape)] = entry
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(data, indent=2, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_entry(kernel: str, shape: dict, *,
               path: Optional[pathlib.Path] = None) -> Optional[BlockConfig]:
    """The tuned config of ``kernel`` at ``shape``; None when there is
    none, when its stamp differs from :func:`runtime_stamp`, or when it
    does not parse as a :class:`BlockConfig`."""
    entry = _load_raw(path)["entries"].get(_entry_key(kernel, shape))
    if not isinstance(entry, dict):
        return None
    stamp = runtime_stamp()
    if any(entry.get(k) != v for k, v in stamp.items()):
        return None
    try:
        return BlockConfig(**{f: entry.get(f, AUTO) for f in _TUNED_FIELDS})
    except (TypeError, ValueError):
        return None


# AUTO's cache lookups by (the two cache variables, kernel, shape). A wrapper
# resolves AUTO at every launch, and a stat of the cache file costs tens
# of microseconds, more than some launches; so the cache is read once per
# launch shape in a process. save_entry empties the memo: a tune in this
# process takes effect at once; an entry another process writes, in the
# next process.
_tuned_memo: dict = {}


def _tuned(kernel: str, shape: dict) -> Optional[BlockConfig]:
    key = (os.environ.get("REPRO_AUTOTUNE"), os.environ.get("REPRO_AUTOTUNE_CACHE"),
           kernel, tuple(shape.items()))
    if key not in _tuned_memo:
        _tuned_memo[key] = load_entry(kernel, shape) if cache_enabled() else None
    return _tuned_memo[key]


# ---------------------------------------------------------------------------
# AUTO resolution for the kernels.ops wrappers
# ---------------------------------------------------------------------------

def gemm_shape(m: int, kw: int, n: int) -> dict:
    return {"m": m, "kw": kw, "n": n}


def resolve_gemm(kernel: str, m: int, kw: int, n: int, tile_n: Knob,
                 k_splits: Knob, sms: int) -> tuple[int, int]:
    """``(tile_n, k_splits)`` of an ``[M, KW] x [KW, N]`` launch of
    ``xnor_gemm`` or ``fused_xnor_gemm``: each AUTO field from the
    tuned entry, else the heuristic (the splits for the resolved
    width)."""
    check_tile_n(tile_n)
    check_k_splits(kw, k_splits)
    if _is_auto(tile_n) or _is_auto(k_splits):
        cfg = _tuned(kernel, gemm_shape(m, kw, n))
        if cfg is not None:
            if _is_auto(tile_n):
                tile_n = cfg.block_n
            if _is_auto(k_splits) and k_splits_ok(kw, cfg.k_splits):
                k_splits = cfg.k_splits
    if _is_auto(tile_n):
        tile_n = heuristic_tile_n(m, n, sms)
    if _is_auto(k_splits):
        k_splits = heuristic_k_splits(m, kw, n, sms, tile_n=tile_n)
    return int(tile_n), int(k_splits)


def conv_shape(n: int, h: int, w: int, cw: int, d: int, kh: int, kw: int,
               stride: int, pad: int) -> dict:
    return {"n": n, "h": h, "w": w, "cw": cw, "d": d, "kh": kh, "kw": kw,
            "stride": stride, "pad": pad}


def resolve_conv(kernel: str, shape: dict, npix: int, tile_n: Knob,
                 sms: int) -> int:
    """``tile_n`` of a direct conv (``fused_direct_conv``,
    ``direct_conv``): the GEMM's heuristic over D x N*OH*OW."""
    check_tile_n(tile_n)
    if _is_auto(tile_n):
        cfg = _tuned(kernel, shape)
        tile_n = cfg.block_n if cfg is not None else AUTO
    if _is_auto(tile_n):
        tile_n = heuristic_tile_n(shape["d"], npix, sms)
    return int(tile_n)


def stage_shape(n: int, h: int, w: int, cw: int, d_words, kh: int, kw: int,
                pad: int, pool: bool) -> dict:
    return {"n": n, "h": h, "w": w, "cw": cw,
            "d": "-".join(str(d) for d in d_words), "kh": kh, "kw": kw,
            "pad": pad, "pool": int(pool)}


def resolve_stage_cluster(shape: dict, cluster: Knob) -> int:
    check_stage_cluster(cluster)
    if _is_auto(cluster):
        cfg = _tuned("megakernel_conv_stage", shape)
        cluster = cfg.stage_cluster if cfg is not None else AUTO
    return STAGE_CLUSTER_AUTO if _is_auto(cluster) else int(cluster)


def chain_shape(kw_layer, m_max: int, kw_max: int, kw_act: int, mf: int,
                kwf: int, n: int) -> dict:
    return {"kws": "-".join(str(k) for k in kw_layer), "m": m_max,
            "kw": kw_max, "kwa": kw_act, "mf": mf, "kwf": kwf, "n": n}


def resolve_chain_cluster(shape: dict, cluster: Knob) -> Knob:
    """The chain's requested or tuned cluster, or AUTO for the heuristic
    (which asks the card: ``ops._chain_cluster``)."""
    check_chain_cluster(cluster, shape["m"])
    if _is_auto(cluster):
        cfg = _tuned("megakernel_chain", shape)
        if cfg is not None and not _is_auto(cfg.chain_cluster):
            check_chain_cluster(cfg.chain_cluster, shape["m"])
            cluster = cfg.chain_cluster
    return cluster


# ---------------------------------------------------------------------------
# Measured tuning
# ---------------------------------------------------------------------------

def time_call(fn: Callable[[], object], repeats: int = 5,
              iters: int = 10) -> float:
    """Device seconds per call of ``fn``: ``iters`` calls captured in one
    CUDA graph (after three calls on a side stream build and warm it),
    replayed ``repeats`` times between CUDA events; the median. No host
    dispatch gap is counted. The one timing protocol of :func:`tune` and
    ``serve.tuning``."""
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
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / iters)
    return statistics.median(times)


def _words(gen: torch.Generator, shape, dev) -> torch.Tensor:
    w = torch.randint(0, 2**32, shape, generator=gen, dtype=torch.int64)
    return (w - ((w >> 31) << 32)).to(torch.int32).to(dev)


def _affine(gen: torch.Generator, m: int, k_bits: int, dev):
    """Per-row (a, b) whose sign threshold lies inside the dot's spread,
    so the packed outputs carry both bit values."""
    sign = torch.where(torch.rand(m, generator=gen) < 0.5, -1.0, 1.0)
    a = (0.5 + torch.rand(m, generator=gen)) * sign
    b = torch.randn(m, generator=gen) * (k_bits ** 0.5) * a.abs()
    return a.float().to(dev), b.float().to(dev)


def _ints(key: str) -> list[int]:
    return [int(v) for v in str(key).split("-")]


@dataclasses.dataclass
class KernelCall:
    """One call of a ``kernels.ops`` wrapper: ``call(**tiling)`` runs it
    with a tiling's keyword arguments added."""

    kernel: str
    args: tuple
    kwargs: dict

    def __call__(self, **tiling):
        from repro_torch.kernels import ops

        return getattr(ops, self.kernel)(*self.args, **self.kwargs, **tiling)


def operands(kernel: str, shape: dict, device) -> KernelCall:
    """A call of ``kernel`` at ``shape`` (a key of this module's
    ``*_shape`` functions) on random operands drawn on the CPU from a
    generator seeded by the shape (the same on every device), then moved
    to ``device``."""
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(
        sum(ord(c) * (i + 1) for i, c in enumerate(_entry_key(kernel, shape)))
        % 2**31)
    s = shape
    if kernel in ("xnor_gemm", "fused_xnor_gemm"):
        k_bits = 32 * s["kw"]
        args = (_words(gen, (s["m"], s["kw"]), dev),
                _words(gen, (s["kw"], s["n"]), dev), k_bits)
        if kernel == "fused_xnor_gemm":
            args += _affine(gen, s["m"], k_bits, dev)
        return KernelCall(kernel, args, {})
    if kernel in ("fused_direct_conv", "direct_conv"):
        k_bits = 32 * s["kh"] * s["kw"] * s["cw"]
        args = (_words(gen, (s["d"], s["kh"] * s["kw"] * s["cw"]), dev),
                _words(gen, (s["n"], s["h"], s["w"], s["cw"]), dev), k_bits)
        if kernel == "fused_direct_conv":
            args += _affine(gen, s["d"], k_bits, dev)
        geo = dict(kh=s["kh"], kw=s["kw"], stride=s["stride"], pad=s["pad"])
        return KernelCall(kernel, args, geo)
    if kernel == "megakernel_conv_stage":
        d_words = _ints(s["d"])
        weights, a, b, k_bits = [], [], [], []
        for cw, dw in zip([s["cw"]] + d_words[:-1], d_words):
            k = 32 * s["kh"] * s["kw"] * cw
            weights.append(_words(gen, (32 * dw, s["kh"] * s["kw"] * cw), dev))
            al, bl = _affine(gen, 32 * dw, k, dev)
            a.append(al)
            b.append(bl)
            k_bits.append(k)
        xp = _words(gen, (s["n"], s["h"], s["w"], s["cw"]), dev)
        return KernelCall(kernel, (xp, weights, a, b, k_bits),
                          dict(kh=s["kh"], kw=s["kw"], pad=s["pad"],
                               pool=bool(s["pool"])))
    if kernel == "megakernel_chain":
        kws = _ints(s["kws"])
        w = _words(gen, (len(kws), s["m"], s["kw"]), dev)
        ab = [_affine(gen, s["m"], 32 * k, dev) for k in kws]
        a = torch.stack([p[0] for p in ab])
        b = torch.stack([p[1] for p in ab])
        xp = _words(gen, (kws[0], s["n"]), dev)
        fin = {}
        if s["mf"]:
            fin = dict(final_wp=_words(gen, (s["mf"], s["kwf"]), dev),
                       final_k_bits=32 * s["kwf"])
        return KernelCall(kernel, (w, a, b, [32 * k for k in kws], xp, s["m"]),
                          fin)
    raise ValueError(f"{kernel!r} has no tiling to tune; tunable: "
                     f"{sorted(k for k, v in KERNEL_KNOBS.items() if v)}")


def default_candidates(kernel: str, shape: dict) -> list[BlockConfig]:
    """Every tiling the kernel compiles at ``shape``: the three tile
    widths (the GEMMs each without a split and with every split count of
    2, 4, 8 and 16 their K takes), or the clusters."""
    if kernel in ("xnor_gemm", "fused_xnor_gemm"):
        kw = shape["kw"]
        splits = [1] + [s for s in (2, 4, 8, 16) if k_splits_ok(kw, s)
                        and kw > _SPLIT_MIN_WORDS]
        return [BlockConfig(block_n=bn, k_splits=s) for bn in TILE_NS
                for s in splits]
    if kernel in ("fused_direct_conv", "direct_conv"):
        return [BlockConfig(block_n=bn) for bn in TILE_NS]
    if kernel == "megakernel_conv_stage":
        return [BlockConfig(stage_cluster=c) for c in STAGE_CLUSTERS]
    if kernel == "megakernel_chain":
        return [BlockConfig(chain_cluster=c) for c in CHAIN_CLUSTERS
                if (shape["m"] // 32) % c == 0]
    raise ValueError(f"{kernel!r} has no tiling to tune")


def tune(kernel: str, shape: dict,
         candidates: Optional[Iterable[BlockConfig]] = None, *,
         device="cuda", cache: bool = True,
         timings: Optional[dict] = None,
         timer: Optional[Callable[[Callable[[], object]], float]] = None
         ) -> BlockConfig:
    """Time ``kernel`` at ``shape`` with each candidate tiling and return
    the fastest, stored in the cache unless ``cache=False`` or
    ``REPRO_AUTOTUNE=0``.

    The ``AUTO`` call runs first; every candidate's output must equal it
    bit for bit before the candidate is timed, else this raises
    ``RuntimeError`` and stores nothing. A candidate the kernel cannot
    run (its wrapper raises ``ValueError``, e.g. a cluster whose shared
    memory exceeds a block's) is left out, with ``None`` in
    ``timings``; ``timings`` also receives the AUTO time under
    ``"auto"`` and every candidate's seconds. ``timer`` (default
    :func:`time_call`) times a call."""
    timer = timer or time_call
    call = operands(kernel, shape, device)
    want = call()
    cands = (list(candidates) if candidates is not None
             else default_candidates(kernel, shape))
    t_auto = timer(call)
    if timings is not None:
        timings[AUTO] = t_auto
    best, best_t = None, float("inf")
    for cfg in cands:
        kwargs = block_kwargs(cfg, kernel)
        try:
            got = call(**kwargs)
        except ValueError:
            if timings is not None:
                timings[cfg] = None
            continue
        if not torch.equal(got, want):
            raise RuntimeError(f"{kernel} at {shape}: tiling {cfg.key()} "
                               "changed the output; nothing is cached")
        t = timer(lambda kwargs=kwargs: call(**kwargs))
        if timings is not None:
            timings[cfg] = t
        if t < best_t:
            best, best_t = cfg, t
    if best is None:
        raise ValueError(f"{kernel} at {shape}: no candidate tiling runs")
    if cache and cache_enabled():
        save_entry(kernel, shape, best, wall_s=best_t)
    return best


__all__ = [
    "AUTO", "BlockConfig", "KERNEL_KNOBS", "TILE_NS", "STAGE_CLUSTERS",
    "CHAIN_CLUSTERS", "block_kwargs", "blocks_key", "split_words",
    "k_splits_ok", "heuristic_tile_n", "heuristic_k_splits",
    "STAGE_CLUSTER_AUTO", "heuristic_chain_clusters", "cache_enabled",
    "cache_path", "runtime_stamp", "save_entry", "load_entry",
    "gemm_shape", "conv_shape", "stage_shape", "chain_shape", "KernelCall",
    "resolve_gemm", "resolve_conv", "resolve_stage_cluster",
    "resolve_chain_cluster", "time_call", "operands", "default_candidates",
    "tune",
]
