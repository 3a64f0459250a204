"""The port's dry run (``launch.dryrun``) against the JAX package's:
the 40-cell grid with its 8 skips, ``build_cell``'s param counts and
model FLOPs on ``tests/test_dryrun_build.py``'s five cells (equal, with
every leaf of the port's cell on meta: nothing allocated), and
``run_cell`` / the CLI on cells that trace in about a second."""

import json

import pytest
import torch

from repro.launch import dryrun as j_dryrun
from repro_torch import tree
from repro_torch.configs import ASSIGNED
from repro_torch.configs.base import SHAPES, cell_applicable, get_config
from repro_torch.launch import dryrun


def test_cell_grid_is_40_with_8_skips_at_long_500k():
    cells = [(a, s) for a in ASSIGNED for s in SHAPES]
    assert len(cells) == 40
    skipped = [(a, s) for a, s in cells
               if not cell_applicable(get_config(a), SHAPES[s])[0]]
    assert len(skipped) == 8 and all(s == "long_500k" for _, s in skipped)


CELLS = [("smollm-360m", "train_4k"), ("moonshot-v1-16b-a3b", "decode_32k"),
         ("seamless-m4t-large-v2", "decode_32k"),
         ("jamba-1.5-large-398b", "long_500k"), ("xlstm-1.3b", "prefill_32k")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_build_cell_counts_match_jax_and_allocate_nothing(arch, shape):
    _, args, donate, model_flops, meta = dryrun.build_cell(arch, shape)
    _, _, j_donate, j_flops, j_meta = j_dryrun.build_cell(arch, shape)
    assert (meta["n_params"], meta["n_active"], model_flops) == (
        j_meta["n_params"], j_meta["n_active"], j_flops)
    assert donate == j_donate and len(args) == 3 and model_flops > 0
    leaves = [x for x in tree.leaves(args) if isinstance(x, torch.Tensor)]
    assert leaves and {x.device.type for x in leaves} == {"meta"}


def test_decode_cell_uses_packed_params():
    _, (params, state, _), _, _, _ = dryrun.build_cell("qwen2.5-3b", "decode_32k")
    assert any(path[-1] == "w_packed" for path, _ in tree.leaves_with_path(params))
    assert "kv" in state and state["kv"]["k"].device.type == "meta"


def test_run_cell_reports_memory_and_roofline(tmp_path):
    """smollm's decode cell on the single-pod mesh: a batch of 128 over 16
    data devices, 8 rows counted."""
    r = dryrun.run_cell("smollm-360m", "decode_32k", "single",
                        out_dir=str(tmp_path), verbose=False)
    assert r["status"] == "ok", r.get("traceback")
    assert r["data_shards"] == 16
    mem = r["memory_analysis"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes", "alias_size_in_bytes"}
    assert 0 < mem["alias_size_in_bytes"] < mem["argument_size_in_bytes"]
    rf = r["roofline"]
    assert rf["chips"] == 256 and rf["hlo_flops_per_chip"] > 0
    assert rf["bottleneck"] in ("compute", "memory", "collective")
    saved = json.loads((tmp_path / "smollm-360m_decode_32k_single.json").read_text())
    assert saved["roofline"] == rf


def test_skipped_cell_keeps_the_jax_reason():
    r = dryrun.run_cell("qwen2.5-3b", "long_500k", "multi", verbose=False)
    j_ok, j_reason = j_dryrun.cell_applicable(
        j_dryrun.get_config("qwen2.5-3b"), j_dryrun.SHAPES["long_500k"])
    assert not j_ok and r == {"arch": "qwen2.5-3b", "shape": "long_500k",
                              "mesh": "multi", "policy": "auto", "tag": "",
                              "status": "skipped", "reason": j_reason}


def test_cli_takes_the_jax_flags_and_exits_clean(tmp_path, capsys):
    assert vars(dryrun.parse_args([])) == dict(
        arch=None, shape=None, mesh="single", policy="auto", all=False,
        out="build/dryrun", tag="", cache_dtype="bf16", microbatches=1)
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "xlstm-1.3b", "--shape", "decode_32k", "--mesh",
                     "both", "--out", str(tmp_path), "--tag", "t",
                     "--cache-dtype", "int8"])
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert out.count("[ok     ] xlstm-1.3b") == 2 and "0 failures" in out
    assert {p.name for p in tmp_path.iterdir()} == {
        "xlstm-1.3b_decode_32k_single_t.json", "xlstm-1.3b_decode_32k_multi_t.json"}
