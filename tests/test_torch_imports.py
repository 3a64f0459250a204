"""The port stands alone: no module of ``src/repro_torch`` (nor the
port's ``chip_smoke.py``) imports ``jax`` or the JAX package ``repro``,
and importing the whole package pulls neither in."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_neither_jax_nor_repro(path):
    assert not imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_package_import_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts).removesuffix(
            ".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_the_megakernel_slice_is_covered():
    """The modules of the megakernel and continuous-serving slice are
    among the files checked above, and their CUDA sources sit beside the
    wrappers that build them."""
    covered = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"serve/continuous.py", "serve/executor.py", "kernels/ops.py",
            "core/layers.py", "core/bnn.py"} <= covered
    from repro_torch.kernels import build

    for name in ("megakernel_conv_stage", "megakernel_chain"):
        assert name in build.SOURCES
        assert (build.CSRC / f"{name}.cu").is_file()


def test_the_packed_slice_is_covered():
    """The modules of the unfused PACKED slice (the paper's Table 2 path)
    are among the files checked above, and the CUDA sources of its three
    kernels sit beside the wrappers that build them."""
    covered = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"configs/bnn_cifar.py", "core/bitops.py", "core/layers.py",
            "core/bnn.py", "kernels/ops.py", "kernels/build.py"} <= covered
    from repro_torch.kernels import build, ops

    for name in ("pack_rows", "unpack_gemm", "direct_conv"):
        assert name in build.SOURCES
        assert (build.CSRC / f"{name}.cu").is_file()
    for symbol in ("repro_pack_rows", "repro_direct_conv_dot",
                   "repro_unpack_gemm"):
        source = build.CSRC / f"{build._LIB_OF[symbol]}.cu"
        assert f"int {symbol}(" in source.read_text()
    assert {"pack_rows", "direct_conv", "unpack_gemm"} <= set(ops.LAUNCHES)


def test_the_lm_slice_is_covered():
    """The modules of the LM serving slice (jamba through
    ``launch/serve.py``) are among the files checked above, and the CUDA
    source of its scan kernel sits beside the wrapper that builds it."""
    covered = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"configs/base.py", "configs/jamba_1_5_large_398b.py",
            "models/common.py", "models/attention.py", "models/ffn.py",
            "models/mamba.py", "models/transformer.py",
            "models/model_factory.py", "launch/serve.py",
            "kernels/ref.py"} <= covered
    from repro_torch.kernels import build, ops

    assert "ssm_scan" in build.SOURCES
    assert build._LIB_OF["repro_ssm_scan_chunk"] == "ssm_scan"
    assert "int repro_ssm_scan_chunk(" in (build.CSRC / "ssm_scan.cu").read_text()
    assert "ssm_scan_chunk" in ops.LAUNCHES


def test_the_training_forward_slice_is_covered():
    """The modules of the LM training forward (``Model.loss`` of
    smollm-360m and xlstm-1.3b) are among the files checked above, and
    the CUDA sources of its two kernels sit beside the wrappers that
    build them."""
    covered = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"configs/smollm_360m.py", "configs/xlstm_1_3b.py",
            "data/pipeline.py", "models/xlstm.py", "models/attention.py",
            "models/transformer.py", "kernels/ref.py"} <= covered
    from repro_torch.kernels import build, ops

    for source, symbol, kernel in (
            ("flash_attention", "repro_flash_attention", "flash_attention"),
            ("mlstm_chunk", "repro_mlstm_chunked", "mlstm_chunked")):
        assert source in build.SOURCES
        assert build._LIB_OF[symbol] == source
        assert f"int {symbol}(" in (build.CSRC / f"{source}.cu").read_text()
        assert kernel in ops.LAUNCHES
