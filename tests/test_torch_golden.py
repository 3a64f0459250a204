"""The golden logits (``tests/golden/bnn_logits.json``: the JAX package's
PACKED ``engine="xla"`` logits of the committed trained checkpoint, as
float32 hex) reproduced by the port, bit for bit, on the CPU.

The fixture's images are ``jax.random.normal(PRNGKey(2024), (4, 32, 32,
3))`` as drawn before jax 0.5 made ``jax_threefry_partitionable`` the
default; they are drawn here inside ``jax.threefry_partitionable(False)``,
a context manager, so the JAX configuration of other tests is left as it
is. Every path below is exact: the ±1 dots are integers, the float first
conv and BN run the same float32 operations in the same order, and on
this checkpoint no sign bit and no logit moves between the packages.
That the port gives all 40 entries exactly also shows the images are the
fixture's.
"""

import json
import pathlib

import jax
import numpy as np
import pytest

from repro_torch.core import bnn as tbnn
from repro_torch.core.binarize import QuantMode

from torch_parity import t

GOLDEN = pathlib.Path(__file__).parent / "golden"
FIXTURE = GOLDEN / "bnn_logits.json"
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def golden():
    data = json.loads(FIXTURE.read_text())
    logits = np.array([[float.fromhex(v) for v in row]
                       for row in data["logits_hex"]], np.float32)
    assert list(logits.shape) == data["shape"]
    with jax.threefry_partitionable(False):
        images = np.asarray(jax.random.normal(
            jax.random.PRNGKey(data["image_seed"]),
            tuple(data["shape"][:1]) + (32, 32, 3)))
    latent = tbnn.load_binary_checkpoint(ROOT / data["checkpoint"], device="cpu")
    return {"logits": logits, "images": images, "latent": latent}


def test_the_context_manager_leaves_the_jax_config_alone(golden):
    before = jax.config.jax_threefry_partitionable
    with jax.threefry_partitionable(not before):
        assert jax.config.jax_threefry_partitionable == (not before)
    assert jax.config.jax_threefry_partitionable == before
    assert golden["images"].shape == (4, 32, 32, 3)


def _packed(latent, x):
    return tbnn.bnn_apply(tbnn.pack_bnn_params(latent), x,
                          tbnn.BNNConfig(mode=QuantMode.PACKED, engine="xla"))


PATHS = {
    "packed_xla": _packed,
    "fused_xla": lambda latent, x: tbnn.bnn_apply_fused(
        tbnn.pack_bnn_params_fused(latent), x, engine="xla"),
    "megakernel_xla": lambda latent, x: tbnn.bnn_apply_megakernel(
        tbnn.pack_bnn_params_megakernel(latent), x, engine="xla"),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_port_reproduces_the_golden_logits(golden, path):
    got = PATHS[path](golden["latent"], t(golden["images"])).numpy()
    np.testing.assert_array_equal(got, golden["logits"])
