"""The port's serving mesh against the JAX package's, on the CPU.

The JAX package serves a 1-D ``("data",)`` mesh through ``shard_map`` on
the 8 host devices ``tests/conftest.py`` forces; the port drives a list of
devices from one process (``launch.mesh``), here 8 CPU entries. Held
equal: the ladder functions over a grid, the shrink plan and the survivors
it keeps, ``bnn_serve_fn(mesh=)``'s logits (bit-identical to the port's
unmeshed forward for every engine x conv_impl x devices 1/2/8, and within
``test_torch_bnn.py``'s tolerance of the JAX package's 8-device forward),
and the snapshots of the JAX package's four mesh scenarios driven through
both packages on one fake clock and one request sequence. Params come
from the trained checkpoint, packed by the JAX package and carried across
(``convert.params_from_numpy``); images from numpy.

The ``cuda`` cases run on the card (replicas sharing it, each with its
own graph pool and stream) and skip here. The JAX package is imported in
fixtures, not at the top, so that the card, which has no JAX, collects
this file."""

import types

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core import bnn as tbnn
from repro_torch.distributed.fault_tolerance import (serving_shrink_plan,
                                                     shrink_serving_mesh)
from repro_torch.distributed.sharding import replicate
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh
from repro_torch.serve import (FaultPlan, FaultSpec, RequestFailed,
                               ServingEngine, default_extents, extent_for,
                               mesh_buckets)

from torch_parity import CKPT  # also: one torch thread per xdist worker

BATCH = 8  # the largest mesh under test gets one image a device
MATRIX = [("xla", "im2col"), ("xla", "direct"), ("xnor", "im2col"),
          ("xnor", "direct"), ("megakernel", "im2col"),
          ("megakernel_xla", "im2col")]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of every comparison."""
    import jax
    import jax.numpy as jnp

    from repro import serve
    from repro.core import bnn
    from repro.distributed import fault_tolerance
    from repro.launch import mesh
    from repro.serve import executor

    if jax.device_count() < 8:
        pytest.skip("needs the 8 host devices tests/conftest.py forces")
    return types.SimpleNamespace(jax=jax, jnp=jnp, bnn=bnn, serve=serve,
                                 executor=executor, mesh=mesh,
                                 ft=fault_tolerance)


@pytest.fixture(scope="module")
def params(jx):
    latent = jx.bnn.load_binary_checkpoint(str(CKPT))
    jfused = jx.bnn.pack_bnn_params_fused(latent)
    jmega = jx.bnn.pack_bnn_params_megakernel(latent)

    def carry(tree):
        return params_from_numpy(jx.jax.tree_util.tree_map(np.asarray, tree),
                                 device="cpu")

    return {"jax_fused": jfused, "jax_mega": jmega,
            "fused": carry(jfused), "mega": carry(jmega)}


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(23).normal(
        size=(BATCH, 32, 32, 3)).astype(np.float32)


def cpu_mesh(n: int) -> ServingMesh:
    return make_serving_mesh(n, device="cpu")


# ------------------------------------------------------------ ladders, mesh

def test_ladders_match_jax(jx):
    jb, je = jx.serve, jx.executor
    for devices in range(1, 9):
        for ladder in ((1, 8, 32, 128), (1, 4, 8), (3, 5, 6), (2,)):
            assert mesh_buckets(ladder, devices) == jb.mesh_buckets(
                ladder, devices), (ladder, devices)
        for tile in (4, 8):
            for n in range(1, 65):
                kw = dict(tile=tile, devices=devices)
                assert extent_for(n, **kw) == je.extent_for(n, **kw), (n, kw)
                assert default_extents(n, **kw) == je.default_extents(n, **kw)
    assert mesh_buckets((1, 8, 32, 128), 4) == (4, 8, 32, 128)
    with pytest.raises(ValueError):
        mesh_buckets((1, 8), 0)


@pytest.mark.parametrize("n,dead", [(8, (5,)), (4, (1,)), (1, (0,)), (8, (99,)),
                                    (8, (2, 6, 7))])
def test_shrink_keeps_the_jax_survivors(jx, n, dead):
    for k in range(10):
        assert serving_shrink_plan(k) == jx.ft.serving_shrink_plan(k)
    jmesh = jx.mesh.make_serving_mesh(n)
    jdevs = list(np.asarray(jmesh.devices).flat)
    jshrunk = jx.ft.shrink_serving_mesh(jmesh, dead)
    mesh = cpu_mesh(n)
    shrunk = shrink_serving_mesh(mesh, dead)
    if jshrunk is None:
        assert shrunk is None
        return
    want = [jdevs.index(d) for d in np.asarray(jshrunk.devices).flat]
    assert [mesh.devices.index(d) for d in shrunk.devices] == want
    assert shrunk.shape == {"data": len(want)}


def test_the_mesh_runs_on_cuda_unless_told_otherwise():
    mesh = make_serving_mesh(3, device="cpu")
    assert [str(d) for d in mesh.devices] == ["cpu:0", "cpu:1", "cpu:2"]
    assert len(make_serving_mesh(device="cpu")) == 1
    with pytest.raises(ValueError):
        make_serving_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="CUDA devices or CPU"):
        ServingMesh(("cpu", "cuda:0"))
    with pytest.raises(ValueError):
        ServingMesh(())
    shared = ServingMesh(("cuda:0",) * 4)     # replicas sharing one card
    assert len(shared) == 4 and len(set(shared.devices)) == 1
    if torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_serving_mesh(torch.cuda.device_count() + 1)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_serving_mesh(2)


def test_replicas_share_one_tree_a_device(params):
    reps = replicate(params["fused"], cpu_mesh(4))
    assert len(reps) == 4 and all(r is reps[0] for r in reps)
    assert reps[0]["conv"][1]["w_packed"] is params["fused"]["conv"][1]["w_packed"]


# ----------------------------------------------------- bnn_serve_fn(mesh=)

@pytest.fixture(scope="module")
def unmeshed(params, images):
    """The port's unmeshed forward of ``images``: every engine and
    conv_impl gives these logits bit for bit (``test_torch_bnn.py``,
    ``test_torch_megakernel.py``), so one forward serves the matrix."""
    fn = tbnn.bnn_serve_fn(engine="xla", conv_impl="im2col")
    return fn(params["fused"], torch.from_numpy(images)).numpy()


@pytest.mark.parametrize("devices", [1, 2, 8])
@pytest.mark.parametrize("engine,conv_impl", MATRIX)
def test_sharded_logits_bit_identical(params, images, unmeshed, engine,
                                      conv_impl, devices):
    """Meshed logits equal the unmeshed forward's; a mesh of 1 or 2 takes
    two images (CPU time: ~0.3 s an image on one thread)."""
    packed = params["mega" if engine.startswith("megakernel") else "fused"]
    mesh = cpu_mesh(devices)
    n = max(devices, 2)
    fn = tbnn.bnn_serve_fn(engine=engine, conv_impl=conv_impl, mesh=mesh)
    got = fn(replicate(packed, mesh), torch.from_numpy(images[:n])).numpy()
    np.testing.assert_array_equal(got, unmeshed[:n])


def test_sharded_rows_must_divide_the_mesh(params, images):
    mesh = cpu_mesh(8)
    fn = tbnn.bnn_serve_fn(engine="xla", mesh=mesh)
    with pytest.raises(ValueError, match="does not divide"):
        fn(replicate(params["fused"], mesh), torch.from_numpy(images[:5]))


@pytest.mark.parametrize("conv_impl", ["im2col", "direct"])
def test_sharded_xla_matches_the_jax_mesh(jx, params, images, conv_impl):
    jfn = jx.bnn.bnn_serve_fn(engine="xla", conv_impl=conv_impl,
                              mesh=jx.mesh.make_serving_mesh(8))
    want = np.asarray(jfn(params["jax_fused"], jx.jnp.asarray(images)))
    mesh = cpu_mesh(8)
    fn = tbnn.bnn_serve_fn(engine="xla", conv_impl=conv_impl, mesh=mesh)
    got = fn(replicate(params["fused"], mesh), torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


# ----------------------------------------- the JAX package's mesh scenarios

def _side(jx, params, port: bool):
    """One package's engines, mesh maker and params for a scenario."""
    if port:
        from repro_torch import serve
        return types.SimpleNamespace(serve=serve, mesh=cpu_mesh,
                                     fused=params["fused"])
    return types.SimpleNamespace(serve=jx.serve, mesh=jx.mesh.make_serving_mesh,
                                 fused=params["jax_fused"])


# The scenarios keep the JAX tests' engines, meshes and faults with fewer
# or smaller requests: on the CPU the port's forward takes ~0.3 s an image
# on one thread, pad rows included.

def scenario_device_loss(s, imgs):
    """tests/test_faults.py: a loss at dispatch 1 shrinks 8 -> 4 and
    re-dispatches free of its retry budget; no build after the re-warm."""
    clk = FakeClock()
    eng = s.serve.ContinuousServingEngine(
        s.fused, engine="xla", max_rows=4, max_wait_s=0.0, mesh=s.mesh(8),
        clock=clk, retry=s.serve.RetryPolicy(max_attempts=1),
        faults=s.serve.FaultPlan([s.serve.FaultSpec("device_loss", at=1,
                                                     device=5)],
                                 sleep=clk.advance))
    eng.warmup()
    rids = []
    for rows in (imgs[:3], imgs[3:6]):
        rids.append(eng.submit(rows))
        eng.step()
        eng.drain()
    assert eng.executors.devices == 4 and eng.extents == (4,)
    built = eng.executors.size
    rids.append(eng.submit(imgs[5:7]))
    eng.step()
    eng.drain()
    assert eng.executors.size == built
    return eng, rids, [imgs[:3], imgs[3:6], imgs[5:7]]


def scenario_heartbeat(s, imgs):
    """tests/test_faults.py: device 3 silent past the timeout shrinks the
    mesh at the next step(), before it dispatches."""
    clk = FakeClock()
    eng = s.serve.ServingEngine(s.fused, engine="xla", buckets=(8,),
                                max_wait_s=0.0, mesh=s.mesh(8),
                                heartbeat_timeout_s=10.0, clock=clk)
    clk.advance(5.0)
    for dev in range(8):
        if dev != 3:
            eng.beat(dev)
    clk.advance(7.0)
    rid = eng.submit(imgs[:3])
    eng.step()
    eng.drain()
    assert eng.executors.devices == 4 and len(eng.monitor.last_beat) == 4
    return eng, [rid], [imgs[:3]]


def scenario_loss_without_mesh(s, imgs):
    """tests/test_faults.py: unmeshed, a DeviceLost cannot shrink and
    burns the retry budget like any failure."""
    clk = FakeClock()
    eng = s.serve.ServingEngine(
        s.fused, buckets=(2,), max_wait_s=0.0, clock=clk,
        retry=s.serve.RetryPolicy(max_attempts=1),
        faults=s.serve.FaultPlan([s.serve.FaultSpec("device_loss", at=0)],
                                 sleep=clk.advance))
    rid = eng.submit(imgs[:2])
    eng.step()
    return eng, [rid], [None]


def scenario_sharded_bucket(s, imgs):
    """tests/test_sharded_serve.py: the bucket engine on 8 devices, its
    ladder (1, 8, 16) rounded to (8, 16)."""
    eng = s.serve.ServingEngine(s.fused, engine="xla", buckets=(1, 8, 16),
                                mesh=s.mesh(8), max_wait_s=0.0)
    assert eng.batcher.buckets == (8, 16) and eng.warmup() == 2
    return _serve(eng, imgs, (1, 3, 10))


def scenario_sharded_continuous(s, imgs):
    """tests/test_sharded_serve.py: the continuous engine on 8 devices,
    extents (8, 16)."""
    eng = s.serve.ContinuousServingEngine(s.fused, engine="xla", max_rows=16,
                                          mesh=s.mesh(8), max_wait_s=0.0)
    assert eng.extents == (8, 16) and eng.warmup() == 2
    return _serve(eng, imgs, (3, 9))


def _serve(eng, imgs, sizes):
    rids, sent = [], []
    for i, n in enumerate(sizes):
        rows = np.resize(np.roll(imgs, i, axis=0), (n,) + imgs.shape[1:])
        rids.append(eng.submit(rows))
        sent.append(rows)
        eng.step()
    eng.drain()
    return eng, rids, sent


SCENARIOS = [scenario_device_loss, scenario_heartbeat,
             scenario_loss_without_mesh, scenario_sharded_bucket,
             scenario_sharded_continuous]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[9:])
def test_scenario_snapshots_match_jax(jx, params, images, scenario):
    (jeng, jrids, _), (eng, rids, sent) = (
        scenario(_side(jx, params, port), images) for port in (False, True))
    jsnap, snap = jeng.snapshot(), eng.snapshot()
    for part in ("mesh", "requests", "degraded"):
        assert snap[part] == jsnap[part], part
    assert snap["batches"]["per_bucket"] == jsnap["batches"]["per_bucket"]
    assert snap["executors"]["compiles"] == jsnap["executors"]["compiles"]
    fn = tbnn.bnn_serve_fn(engine="xla")
    for jrid, rid, rows in zip(jrids, rids, sent):
        got, jgot = eng.take(rid), jeng.take(jrid)
        if rows is None:
            assert isinstance(got, RequestFailed) and "DeviceLost" in got.error
            assert type(jgot).__name__ == "RequestFailed"
            continue
        np.testing.assert_array_equal(
            got, fn(params["fused"], torch.from_numpy(rows)).numpy())
        np.testing.assert_allclose(got, jgot, rtol=1e-6, atol=1e-5)
    if eng.executors.mesh is not None:      # the same survivors
        jdevs = np.asarray(jeng.executors.mesh.devices).flat
        assert [d.index for d in eng.executors.mesh.devices] == [
            d.id for d in jdevs]
        n = eng.executors.devices
        assert eng.snapshot()["executors"]["keys"][-1].endswith(f"|mesh{n}")


# ------------------------------------------------------------- on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def card_params():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    latent = tbnn.init_bnn_params(12, device="cuda")
    return {"fused": tbnn.pack_bnn_params_fused(latent),
            "mega": tbnn.pack_bnn_params_megakernel(latent)}


CARD_ENGINES = [("xnor", "direct"), ("xnor", "im2col"), ("xla", "direct"),
                ("megakernel", "im2col"), ("megakernel_xla", "im2col")]


@pytest.mark.cuda
@pytest.mark.parametrize("engine,conv_impl", CARD_ENGINES)
def test_meshed_graphs_equal_the_eager_forward(dev, card_params, engine,
                                               conv_impl):
    from repro_torch.serve import ExecutorCache, RaggedExecutorCache

    packed = card_params["mega" if engine.startswith("megakernel") else "fused"]
    mesh = ServingMesh((dev,) * 2)
    rng = np.random.default_rng(90)
    caches = [(ExecutorCache, mesh_buckets((1, 8, 32), 2), False)]
    if engine.startswith("megakernel"):
        caches.append((RaggedExecutorCache, default_extents(32, devices=2),
                       True))
    for cls, shapes, ragged in caches:
        cache = cls(packed, engine=engine, conv_impl=conv_impl, mesh=mesh)
        eager = tbnn.bnn_serve_fn(engine=engine, conv_impl=conv_impl,
                                  ragged=ragged)
        for rows in shapes:
            x = rng.normal(size=(rows, 32, 32, 3)).astype(np.float32)
            got = cache.run(x)
            want = eager(packed, torch.from_numpy(x).to(dev)).cpu().numpy()
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{cls.__name__} {rows}")
        assert cache.size == len(shapes)
        assert all(k[-1] == "mesh2" for k in cache._fns)


@pytest.mark.cuda
def test_replicas_on_one_card_replay_concurrently(dev, card_params):
    from repro_torch.serve import ExecutorCache

    packed = card_params["fused"]
    cache = ExecutorCache(packed, engine="xnor", conv_impl="direct",
                          mesh=ServingMesh((dev,) * 2))
    ex = cache.get(32)
    a, b = ex.replicas
    assert a.stream is not None and b.stream is not None
    assert a.stream != b.stream and a.graph is not b.graph
    assert cache._replicas[0][2] != cache._replicas[1][2]   # graph pools
    eager = tbnn.bnn_serve_fn(engine="xnor", conv_impl="direct")
    rng = np.random.default_rng(91)
    for _ in range(20):
        x = rng.normal(size=(32, 32, 32, 3)).astype(np.float32)
        ex.launch(x)
        got = ex.collect()
        for half in (slice(0, 16), slice(16, 32)):
            want = eager(packed, torch.from_numpy(x[half]).to(dev)).cpu().numpy()
            np.testing.assert_array_equal(got[half], want)


@pytest.mark.cuda
def test_a_shrink_releases_and_recaptures(dev, card_params):
    from repro_torch.kernels import ops

    clk = FakeClock()
    eng = ServingEngine(card_params["fused"], engine="xnor",
                        conv_impl="direct", buckets=(8,), max_wait_s=0.0,
                        mesh=ServingMesh((dev,) * 4), clock=clk,
                        faults=FaultPlan([FaultSpec("device_loss", at=1,
                                                    device=2)]))
    assert eng.warmup() == 1
    old = eng.executors
    rng = np.random.default_rng(92)
    reqs = [rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
            for n in (5, 8, 3)]
    eager = tbnn.bnn_serve_fn(engine="xnor", conv_impl="direct")
    rids = []
    for x in reqs:
        rids.append(eng.submit(x))
        eng.step()
    eng.drain()
    assert old.size == 0 and eng.executors is not old
    assert eng.executors.devices == 2 and eng.executors.size == 1
    assert list(eng.executors._fns) == [(8, "xnor", "direct", "auto", "mesh2")]
    before = dict(ops.LAUNCHES)
    rids.append(eng.submit(reqs[0]))
    eng.step()
    # one dispatch on two replicas: 2 x (5 + 2 + 1) launches
    assert sum(ops.LAUNCHES.values()) - sum(before.values()) == 16
    for rid, x in zip(rids, reqs + reqs[:1]):
        want = eager(card_params["fused"], torch.from_numpy(x).to(dev))
        np.testing.assert_array_equal(eng.take(rid), want.cpu().numpy())
    snap = eng.snapshot()
    assert snap["mesh"] == {"shrinks": 1, "devices": 2}
    assert snap["requests"]["failed"] == 0

