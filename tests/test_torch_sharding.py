"""The port's LM rule table and production meshes against the JAX
package's: ``param_spec`` / ``state_spec`` / ``batch_spec`` of every leaf
of the ten full-width trees (float params, packed params, the decode
state, the four shapes' batches) on both production meshes, a hypothesis
property on random shapes and paths, and the cases of
``tests/test_distributed.py``. Specs compare as tuples, exactly.

The JAX trees come from ``jax.eval_shape`` and the port's from
``Model.init()`` / ``init_packed()`` with no generator (meta tensors), so
no full-width weight is allocated on either side.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.distributed import sharding as j_sharding
from repro.launch import mesh as j_mesh
from repro.models.model_factory import build_model as j_build_model
from repro_torch import tree
from repro_torch.configs import ASSIGNED
from repro_torch.configs.base import SHAPES, get_config, serve_policy, train_policy
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import (MULTI_POD, SINGLE_POD, AbstractMesh,
                                     ServingMesh, make_production_mesh)
from repro_torch.models.model_factory import build_model

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hypothesis is optional in some containers
    given = None


class _ShapeMesh:
    """Duck-typed mesh exposing only .shape for the JAX rule functions."""

    def __init__(self, **axes):
        self.shape = axes


MESHES = {"single": make_production_mesh(), "multi": make_production_mesh(multi_pod=True)}


def j_mesh_of(mesh: AbstractMesh) -> _ShapeMesh:
    return _ShapeMesh(**mesh.shape)


def j_specs(rule, mesh, jtree) -> list:
    return [(tuple(j_sharding._path_keys(path)), tuple(rule(mesh, path, leaf)))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]]


def t_specs(rule, mesh, ttree) -> list:
    return [(path, tuple(rule(mesh, path, leaf)))
            for path, leaf in tree.leaves_with_path(ttree)]


@functools.lru_cache(maxsize=None)
def j_trees(arch: str):
    cfg = j_configs.get_config(arch)
    model = j_build_model(cfg, j_configs.serve_policy())
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    packed = jax.eval_shape(model.pack, params)
    dec = j_configs.SHAPES["decode_32k"]
    state = jax.eval_shape(functools.partial(
        model.init_state, dec.global_batch, dec.seq_len, dtype=jnp.bfloat16))
    batches = {name: model.input_specs(shape)
               for name, shape in j_configs.SHAPES.items()}
    return params, packed, state, batches


@pytest.mark.parametrize("arch", ASSIGNED)
def test_rule_table_matches_jax_on_every_full_width_leaf(arch):
    """Float params, packed params, the decode state and every shape's
    batch, leaf by leaf, on the single- and multi-pod meshes."""
    jp, jpk, jst, jb = j_trees(arch)
    model = build_model(get_config(arch), serve_policy())
    tp, tpk = model.init(), model.init_packed()
    dec = SHAPES["decode_32k"]
    tst = model.init_state(dec.global_batch, dec.seq_len, device="meta")
    assert {leaf.device.type for leaf in tree.leaves(tp) + tree.leaves(tpk)} == {"meta"}
    for mesh in MESHES.values():
        jm = j_mesh_of(mesh)
        for rule, jr, a, b in ((sharding.param_spec, j_sharding.param_spec, jp, tp),
                               (sharding.param_spec, j_sharding.param_spec, jpk, tpk),
                               (sharding.state_spec, j_sharding.state_spec, jst, tst)):
            assert t_specs(rule, mesh, b) == j_specs(jr, jm, a)
        for name, shape in SHAPES.items():
            assert (t_specs(sharding.batch_spec, mesh, model.input_specs(shape))
                    == j_specs(j_sharding.batch_spec, jm, jb[name]))


def test_tree_forms_hold_each_leafs_spec():
    model = build_model(get_config("qwen2.5-3b"), train_policy())
    params = model.init()
    mesh = MESHES["multi"]
    specs = sharding.params_shardings(mesh, params)
    for path, leaf in tree.leaves_with_path(params):
        node = specs
        for k in path:
            node = node[k]
        assert node == sharding.param_spec(mesh, path, leaf)
        assert isinstance(node, sharding.PartitionSpec)
    assert sharding.replicated(mesh) == ()


def test_production_meshes_are_the_jax_package_s():
    assert (SINGLE_POD, MULTI_POD) == (j_mesh.SINGLE_POD, j_mesh.MULTI_POD)
    for multi, shape in ((False, SINGLE_POD), (True, MULTI_POD)):
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.axis_names == ("pod", "data", "model")
        assert tuple(mesh.shape.values()) == shape
        assert list(mesh.shape) == ["pod", "data", "model"]
        assert mesh.size == sharding.mesh_devices(mesh) == int(np.prod(shape))
    with pytest.raises(ValueError):
        AbstractMesh((2, 16))


# --------------------------------- property ----------------------------------

_PATHS = [("q_proj", "w"), ("down_proj", "w"), ("o_proj", "w"),
          ("moe", "up_proj", "w"), ("moe", "router", "w"), ("lm_head", "w"),
          ("embed", "table"), ("up_proj", "w_packed"), ("moe", "up_proj", "w_packed"),
          ("layers", 0, "attn", "q_proj", "w"), ("layers", 1, "ffn", "down_proj", "w"),
          ("layers", 0, "attn", "q_proj", "b"), ("layers", 0, "ffn", "up_proj", "alpha"),
          ("layers", 0, "mamba", "A_log"), ("layers", 0, "norm1", "scale"),
          ("layers", 2, "moe", "down_proj", "w_packed")]
_STATE_PATHS = [("kv", "k"), ("kv", "v"), ("memory",), ("mamba", "h"),
                ("mlstm", "C"), ("slstm", "m"), ("index",)]


def _j_path(path):
    return tuple(jax.tree_util.SequenceKey(k) if isinstance(k, int)
                 else jax.tree_util.DictKey(k) for k in path)


def _outcome(rule, *args):
    try:
        return tuple(rule(*args))
    except IndexError:
        return "IndexError"


def _check_against_jax(dims, pod, data, model):
    axes = dict(pod=pod, data=data, model=model) if pod else dict(data=data, model=model)
    mesh, jm = AbstractMesh(tuple(axes.values()), tuple(axes)), _ShapeMesh(**axes)
    leaf = torch.empty(tuple(dims), device="meta")
    jleaf = jax.ShapeDtypeStruct(tuple(dims), jnp.float32)
    for path in _PATHS:
        spec = sharding.param_spec(mesh, path, leaf)
        assert tuple(spec) == tuple(j_sharding.param_spec(jm, _j_path(path), jleaf))
        assert len(sharding.shard_shape(mesh, dims, spec)) == len(dims)
    for path in _STATE_PATHS:   # a KV path on too few dims raises in both
        assert (_outcome(sharding.state_spec, mesh, path, leaf)
                == _outcome(j_sharding.state_spec, jm, _j_path(path), jleaf))
    assert (tuple(sharding.batch_spec(mesh, ("tokens",), leaf))
            == tuple(j_sharding.batch_spec(jm, _j_path(("tokens",)), jleaf)))


if given is not None:
    @given(dims=st.lists(st.sampled_from([1, 2, 3, 4, 8, 15, 16, 32, 48, 64, 96, 256]),
                         min_size=1, max_size=5),
           pod=st.sampled_from([0, 1, 2]), data=st.sampled_from([1, 2, 4, 16]),
           model=st.sampled_from([1, 4, 16]))
    @settings(max_examples=60, deadline=None)
    def test_specs_match_jax_on_random_shapes_and_paths(dims, pod, data, model):
        """``tests/test_properties.py``'s divisibility property, held to the
        JAX rule functions themselves on each path of ``_PATHS`` /
        ``_STATE_PATHS`` (a mesh with no ``pod`` axis too)."""
        _check_against_jax(dims, pod, data, model)
else:
    @pytest.mark.parametrize("dims,pod,data,model", [
        ([4, 64, 48], 2, 16, 16), ([15, 960], 1, 16, 4), ([1, 2, 3], 0, 2, 4),
        ([8, 1, 2048, 8, 128], 2, 16, 16), ([128, 4864, 256], 1, 4, 16)])
    def test_specs_match_jax_on_random_shapes_and_paths(dims, pod, data, model):
        _check_against_jax(dims, pod, data, model)


# ------------------------- tests/test_distributed.py --------------------------

MESH = AbstractMesh((2, 16, 16))


def _leaf(*shape):
    # Frontier-scale cases (the FSDP one is 1.25 TB dense) stay on meta.
    return torch.empty(shape, device="meta")


def test_column_parallel_weight_spec():
    spec = sharding.param_spec(MESH, ("layers", 0, "attn", "q_proj", "w"),
                               _leaf(22, 12288, 12288))
    assert spec == (None, "model", ("pod", "data"))


def test_row_parallel_weight_spec():
    spec = sharding.param_spec(MESH, ("layers", 0, "ffn", "down_proj", "w"),
                               _leaf(22, 12288, 28672))
    assert spec == (None, ("pod", "data"), "model")


def test_expert_stack_spec_small_replicates_over_data():
    spec = sharding.param_spec(MESH, ("layers", 0, "moe", "up_proj", "w"),
                               _leaf(48, 64, 1408, 2048))
    assert spec == (None, "model", None, None)


def test_expert_stack_spec_big_gets_fsdp():
    spec = sharding.param_spec(MESH, ("layers", 0, "moe", "up_proj", "w"),
                               _leaf(35, 128, 4864, 7168))
    assert spec == (None, "model", None, ("pod", "data"))


def test_indivisible_axis_left_unsharded():
    spec = sharding.param_spec(MESH, ("q_proj", "w"), np.zeros((17, 960)))
    assert spec == (None, ("pod", "data"))


def test_packed_weight_spec_replicated_over_data():
    spec = sharding.param_spec(MESH, ("ffn", "up_proj", "w_packed"),
                               np.zeros((2560, 30)))
    assert spec == ("model", None)


def test_kv_cache_spec():
    spec = sharding.state_spec(MESH, ("kv", "k"), _leaf(8, 128, 1024, 8, 128))
    assert spec == (None, ("pod", "data"), "model", None, None)


def test_kv_cache_batch1_seq_sharded():
    spec = sharding.state_spec(MESH, ("kv", "k"), np.zeros((8, 1, 2048, 8, 128)))
    assert spec == (None, None, "model", None, None)


def test_mesh_devices_counts_all_axes():
    assert sharding.mesh_devices(None) == 1
    assert sharding.mesh_devices(_ShapeMesh(data=8)) == 8
    assert sharding.mesh_devices(MESH) == 2 * 16 * 16
    assert sharding.mesh_devices(ServingMesh(("cpu",) * 3)) == 3


def test_shard_shape_divides_each_sharded_dim():
    spec = sharding.param_spec(MESH, ("layers", 0, "ffn", "down_proj", "w"),
                               _leaf(22, 12288, 28672))
    assert sharding.shard_shape(MESH, (22, 12288, 28672), spec) == (22, 384, 1792)
    assert sharding.shard_shape(MESH, (5, 7), sharding.P()) == (5, 7)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.shard_shape(MESH, (17, 960), sharding.P("model", None))
