"""The port's device meshes, shardings and sharded trainer against the
JAX package's ``parallel`` (``seldon_core_tpu_torch/parallel``).

The JAX side runs on conftest's eight host devices; the port's meshes
are explicit lists of CPU positions.  Specs compare leaf for leaf; the
trainers start from the same weights (the JAX module's, carried through
``models/convert.py``) and compare losses and parameters after two steps.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.mlp import MLPClassifier as FlaxMLP
from seldon_core_tpu.models.resnet import ResNetTiny as FlaxResNetTiny
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu.ops.surgery import QuantizedKernel as JaxQuantizedKernel
from seldon_core_tpu.parallel import ShardedTrainer as JaxShardedTrainer
from seldon_core_tpu.parallel import create_mesh as jax_create_mesh
from seldon_core_tpu.parallel import infer_param_specs as jax_infer_param_specs
from seldon_core_tpu.parallel import mesh as jax_mesh
from seldon_core_tpu_torch.models.convert import mlp_params_from_flax, resnet_params_from_flax
from seldon_core_tpu_torch.models.cudaserver import CudaServer
from seldon_core_tpu_torch.models.mlp import MLPClassifier
from seldon_core_tpu_torch.models.resnet import ResNetTiny
from seldon_core_tpu_torch.ops.surgery import QuantizedKernel
from seldon_core_tpu_torch.parallel import (P, ShardedTensor, ShardedTrainer, all_gather, all_reduce, create_mesh,
                                            data_sharded, infer_param_specs, mesh_from_axes, mesh_shape, ppermute,
                                            replicated, resolve_dp, resolve_mesh, resolve_tp, shard_params,
                                            single_device_mesh, tp_mesh)
from seldon_core_tpu_torch.parallel import mesh as port_mesh
from seldon_core_tpu_torch.parallel.sharding import shard_decode_state, sharding_tree
from seldon_core_tpu_torch.utils import serialization

CPU4 = ["cpu"] * 4
CPU8 = ["cpu"] * 8
LOG = "seldon_core_tpu_torch.parallel"


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for name in ("SELDON_TPU_TP", "SELDON_TPU_DP", "SELDON_TPU_SEQ_SHARD"):
        monkeypatch.delenv(name, raising=False)


def _fake_cards(monkeypatch, n):
    """``n`` distinct CUDA devices as the knobs count them (no tensor is
    ever placed on them here)."""
    monkeypatch.setattr(port_mesh, "available_devices", lambda: [torch.device("cuda", i) for i in range(n)])


# ---------------------------------------------------------------- meshes


class TestMesh:
    def test_default_all_data_and_wildcard(self):
        assert mesh_shape(create_mesh(devices=CPU8)) == {"data": 8}
        assert mesh_shape(create_mesh({"data": -1, "model": 2}, devices=CPU8)) == {"data": 4, "model": 2}
        assert mesh_shape(jax_create_mesh({"data": -1, "model": 2})) == {"data": 4, "model": 2}

    @pytest.mark.parametrize("axes,message", [
        ({"data": 16}, "needs 16 devices, have 8"),
        ({"data": -1, "model": -1}, "at most one mesh axis may be -1"),
        ({"data": -1, "model": 3}, "8 devices not divisible by 3"),
    ])
    def test_rules_and_messages_are_jax_s(self, axes, message):
        with pytest.raises(ValueError, match=message):
            create_mesh(axes, devices=CPU8)
        with pytest.raises(ValueError, match=message):
            jax_create_mesh(axes)

    def test_no_card_no_devices_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="never falls back to the CPU"):
            create_mesh({"data": 1})

    def test_positions_may_repeat_a_device(self):
        mesh = create_mesh({"data": 2, "model": 2}, devices=CPU4)
        assert mesh.devices.shape == (2, 2) and mesh.distinct_devices() == [torch.device("cpu")]
        assert list(mesh.positions()) == [(0, 0), (0, 1), (1, 0), (1, 1)]
        assert mesh_shape(single_device_mesh("cpu")) == {"data": 1}
        assert mesh_from_axes(None) is None
        assert mesh_shape(mesh_from_axes({"model": 2}, devices=["cpu"] * 2)) == {"model": 2}


class TestKnobs:
    """resolve_tp / resolve_dp / resolve_mesh / tp_mesh: JAX's precedence
    and degrade order, counted in distinct CUDA devices."""

    @pytest.mark.parametrize("resolve,jax_resolve,env", [(resolve_tp, jax_mesh.resolve_tp, "SELDON_TPU_TP"),
                                                         (resolve_dp, jax_mesh.resolve_dp, "SELDON_TPU_DP")])
    def test_degree_precedence(self, resolve, jax_resolve, env, monkeypatch):
        for value, explicit in (("4", 2), ("4", 1), ("2", None), ("2", 0), ("0", None), ("", None)):
            monkeypatch.setenv(env, value)
            assert resolve(explicit) == jax_resolve(explicit)
        monkeypatch.delenv(env)
        assert resolve(None) == 1
        with pytest.raises(ValueError, match="must be >= 1"):
            resolve(-2)

    def test_explicit_mesh_then_axes_then_degrees(self, monkeypatch):
        _fake_cards(monkeypatch, 8)
        mesh = create_mesh({"model": 2}, devices=["cpu"] * 2)
        assert resolve_mesh(mesh=mesh, tp=4, dp=2) is mesh
        monkeypatch.setenv("SELDON_TPU_TP", "4")
        monkeypatch.setenv("SELDON_TPU_DP", "2")
        assert mesh_shape(resolve_mesh(mesh_axes={"model": 2}, devices=["cpu"] * 2)) == {"model": 2}
        assert mesh_shape(resolve_mesh(tp=2, dp=1)) == {"model": 2}
        assert mesh_shape(resolve_mesh()) == {"data": 2, "model": 4}

    def test_size_one_axes_drop_and_data_major(self, monkeypatch):
        _fake_cards(monkeypatch, 8)
        assert resolve_mesh(tp=1, dp=1) is None and tp_mesh(1) is None
        assert mesh_shape(resolve_mesh(dp=2, tp=1)) == {"data": 2}
        mesh = resolve_mesh(dp=2, tp=2)
        assert mesh.axis_names == ("data", "model")
        # each model group spans adjacent devices
        assert [d.index for d in mesh.devices[0]] == [0, 1]
        jm = jax_mesh.resolve_mesh(dp=2, tp=2)
        assert mesh_shape(mesh) == jax_mesh.mesh_shape(jm)

    def test_degrade_shrinks_data_first_with_jax_s_warn(self, monkeypatch, caplog):
        _fake_cards(monkeypatch, 4)
        with caplog.at_level(logging.WARNING, logger=LOG + ".mesh"):
            mesh = resolve_mesh(dp=4, tp=2)
        assert mesh_shape(mesh) == {"data": 2, "model": 2}
        assert "shrinking the data axis first: (data=2, model=2)" in caplog.text
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=LOG + ".mesh"):
            assert resolve_mesh(dp=2, tp=8) is None
        assert "(data=2, model=8)" in caplog.text and "degrading to single-chip (data=1, model=1)" in caplog.text
        with pytest.raises(ValueError, match="shrinking the data axis"):
            resolve_mesh(dp=4, tp=2, strict=True)

    def test_one_card_degrades_tp_with_the_warn(self, monkeypatch, caplog):
        _fake_cards(monkeypatch, 1)
        monkeypatch.setenv("SELDON_TPU_TP", "2")
        with caplog.at_level(logging.WARNING, logger=LOG + ".mesh"):
            assert tp_mesh() is None
        assert "tensor-parallel degree 2 needs 2 devices but the host exposes 1" in caplog.text
        with pytest.raises(ValueError, match="degrading to single-chip"):
            tp_mesh(strict=True)


# ---------------------------------------------------------------- shardings


@pytest.fixture(scope="module")
def lm_flax():
    lm = FlaxTransformerLM(dtype=jnp.float32, vocab_size=64, d_model=32, num_layers=2, num_heads=4, max_len=64)
    return jax.device_get(lm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*prefix, k))
    else:
        yield prefix, tree


class TestSpecs:
    @pytest.mark.parametrize("axes", [{"model": 2}, {"data": 2, "model": 2}, {"data": 4}])
    @pytest.mark.parametrize("min_size", [0, 1024, 16_384])
    def test_spec_trees_equal_jax_s_leaf_for_leaf(self, lm_flax, axes, min_size):
        n = int(np.prod(list(axes.values())))
        theirs = jax_infer_param_specs(lm_flax, jax_create_mesh(axes, devices=jax.devices()[:n]),
                                       min_weight_size=min_size)
        mine = infer_param_specs(lm_flax, create_mesh(axes, devices=["cpu"] * n), min_weight_size=min_size)
        flat_theirs = dict(_leaves(theirs))
        flat_mine = dict(_leaves(mine))
        assert set(flat_theirs) == set(flat_mine)
        for path, spec in flat_theirs.items():
            assert tuple(flat_mine[path]) == tuple(spec), path

    def test_quantized_kernels_get_jax_s_paired_specs(self):
        jmesh = jax_create_mesh({"data": 4, "model": 2})
        mesh = create_mesh({"data": 4, "model": 2}, devices=CPU8)
        for shape in ((256, 128), (64, 33)):
            q = np.zeros(shape, np.int8)
            theirs = jax_infer_param_specs({"w": JaxQuantizedKernel(q, np.ones((shape[1],), np.float32))}, jmesh,
                                           min_weight_size=1024)["w"]
            # the port's QuantizedKernel keeps the torch layout (out, in)
            qk = QuantizedKernel(torch.zeros(shape[::-1], dtype=torch.int8), torch.ones(shape[1]))
            mine = infer_param_specs({"w": qk}, mesh, min_weight_size=1024)["w"]
            assert tuple(mine.q) == tuple(theirs.q)[::-1] and tuple(mine.scale) == tuple(theirs.scale)
        named = sharding_tree({"w": P(None, "model")}, mesh)["w"]
        assert named.spec == P(None, "model") and named.mesh == mesh
        assert replicated(mesh).spec == P() and data_sharded(mesh).spec == P("data")


class TestPlacement:
    def test_shard_params_slices_a_position_and_replicates_once_a_device(self):
        mesh = create_mesh({"data": 4, "model": 2}, devices=CPU8)
        w = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
        out = shard_params({"w": w, "b": torch.ones(8)}, mesh, min_weight_size=1024)
        sw, sb = out["w"], out["b"]
        assert sw.spec == P("model", None) and sw.local((0, 0)).shape == (32, 32)
        assert torch.equal(sw.local((3, 1)), w[32:]) and torch.equal(sw.full(), w)
        # a sharded leaf: its own tensor at every position; a replicated
        # one: one tensor for the one distinct device
        assert len({id(t) for t in sw.shards.flat}) == 2 and len({id(t) for t in sb.shards.flat}) == 1
        assert sw.distinct_nbytes() == w.numel() * 4

    def test_rejected_spec_degrades_replicated_with_the_warn(self, caplog):
        mesh = create_mesh({"model": 2}, devices=["cpu"] * 2)
        with caplog.at_level(logging.WARNING, logger=LOG + ".sharding"):
            out = shard_params({"w": torch.ones(3, 5), "x": "not an array"}, mesh,
                               specs={"w": P("model", None), "x": P()})
        assert isinstance(out["w"], ShardedTensor) and out["w"].spec == P() and out["x"] == "not an array"
        assert "rejected spec" in caplog.text and "not device-placeable" in caplog.text

    def test_quantized_kernel_round_trip(self):
        mesh = create_mesh({"data": 4, "model": 2}, devices=CPU8)
        q = (torch.arange(32 * 64) % 7).to(torch.int8).reshape(32, 64)
        qk = QuantizedKernel(q, torch.linspace(0.5, 1.5, 32))
        out = shard_params({"w": qk}, mesh, min_weight_size=512)["w"]
        assert out.q.local((0, 0)).shape == (16, 64) and out.scale.local((0, 0)).shape == (16,)
        assert torch.equal(out.q.full(), q) and torch.equal(out.scale.full(), qk.scale)

    def test_decode_state_pools_on_both_axes(self):
        mesh = create_mesh({"data": 2, "model": 2}, devices=CPU4)
        _, pk, _ = shard_decode_state({}, mesh, pool_shape=(1, 8, 4, 4, 8), dtype=torch.float32)
        assert pk.spec == P(None, "data", None, "model") and pk.local((1, 1)).shape == (1, 4, 4, 2, 8)
        assert pk.position_nbytes((0, 0)) * 4 == 1 * 8 * 4 * 4 * 8 * 4
        _, one, _ = shard_decode_state({}, None, pool_shape=(1, 8, 4, 4, 8), dtype=torch.float32, device="cpu")
        assert torch.is_tensor(one) and tuple(one.shape) == (1, 8, 4, 4, 8)

    @pytest.mark.parametrize("seq_shard,heads,pages,want,warn", [
        (True, 3, 8, P(None, "data", None, None), "num_heads=3 is not divisible"),
        (True, 4, 5, P(None, None, None, "model"), "num_pages=5 is not divisible"),
        (False, 4, 5, P(None, None, None, "model"), ""),
    ])
    def test_decode_state_refusals_warn_as_jax(self, seq_shard, heads, pages, want, warn, caplog):
        mesh = create_mesh({"data": 2, "model": 2}, devices=CPU4)
        with caplog.at_level(logging.WARNING, logger=LOG + ".sharding"):
            _, pk, _ = shard_decode_state({}, mesh, pool_shape=(1, pages, 4, heads, 8), dtype=torch.float32,
                                          seq_shard=seq_shard)
        assert pk.spec == want
        assert (warn in caplog.text) if warn else "NOT sharded" not in caplog.text

    def test_pool_take_and_put_cross_shards(self):
        mesh = create_mesh({"data": 2, "model": 2}, devices=CPU4)
        _, pk, _ = shard_decode_state({}, mesh, pool_shape=(2, 8, 4, 4, 8), dtype=torch.float32)
        pages = torch.tensor([1, 6, 3])
        value = torch.randn(2, 3, 4, 4, 8)
        pk[:, pages] = value
        assert torch.equal(pk[:, pages], value) and torch.equal(pk.full()[:, pages], value)
        assert float(pk.full()[:, [0, 2, 4, 5, 7]].abs().sum()) == 0.0

    def test_collectives(self):
        parts = [torch.full((2,), float(i)) for i in range(4)]
        assert torch.equal(all_gather(parts, 0, "cpu"), torch.tensor([0., 0., 1., 1., 2., 2., 3., 3.]))
        assert torch.equal(all_reduce(parts, "cpu"), torch.full((2,), 6.0))
        moved = ppermute(parts, [(j, (j + 1) % 4) for j in range(4)], [torch.device("cpu")] * 4)
        assert [float(m[0]) for m in moved] == [3.0, 0.0, 1.0, 2.0]


# ---------------------------------------------------------------- the trainer


def _tree_get(tree, path):
    for k in path:
        tree = tree[k.key]
    return np.asarray(tree)


def _assert_trainers_agree(jt, pt, grads_step1):
    """Parameters within 1e-5 of the JAX trainer's, leaf for leaf.  A leaf
    whose first-step JAX gradient is rounding noise (below 1e-6: a
    direction BatchNorm's normalisation makes the loss flat in, such as
    the stem BatchNorm's bias in ResNetTiny) is held to the AdamW step
    bound instead: Adam normalises any nonzero gradient into a step of
    about the learning rate, so its sign there is the summation order's."""
    mine = pt.serving_variables()
    bound = 2 * pt.step * pt.learning_rate
    for path, theirs in jax.tree_util.tree_flatten_with_path(jax.device_get(jt.params))[0]:
        got = _tree_get(mine["params"], path)
        if float(np.abs(_tree_get(grads_step1, path)).max()) < 1e-6:
            assert float(np.abs(got - np.asarray(theirs)).max()) <= bound, path
            continue
        np.testing.assert_allclose(got, np.asarray(theirs), rtol=1e-5, atol=1e-5, err_msg=str(path))
    return mine


class TestShardedTrainer:
    def test_mlp_dp4_tp2_matches_jax(self):
        jt = JaxShardedTrainer(FlaxMLP(hidden_sizes=(32, 32), num_classes=3), np.zeros(4, np.float32),
                               jax_create_mesh({"data": 4, "model": 2}), has_batch_stats=False, min_weight_size=0)
        init = jax.device_get(jt.params)
        pt = ShardedTrainer(MLPClassifier(hidden_sizes=(32, 32), num_classes=3, in_features=4),
                            np.zeros(4, np.float32), create_mesh({"data": 4, "model": 2}, devices=CPU8),
                            has_batch_stats=False, min_weight_size=0, params=mlp_params_from_flax(init))
        # JAX's specs of the flax leaves, in the port's layout
        assert pt.specs["dense_1.weight"] == P(None, "model") and pt.params["dense_1.weight"].local(
            (0, 1)).shape == (32, 16)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(16, 4)).astype(np.float32)
        y = (x.sum(axis=1) > 0).astype(np.int32)
        grads = jax.grad(lambda p: _jax_loss(FlaxMLP(hidden_sizes=(32, 32), num_classes=3), {"params": p}, x, y))(init)
        for _ in range(2):
            theirs, mine = jt.train_batch(x, y), pt.train_batch(x, y)
            assert mine["loss"] == pytest.approx(theirs["loss"], rel=1e-5) and mine["step"] == theirs["step"]
            assert mine["accuracy"] == theirs["accuracy"]
        _assert_trainers_agree(jt, pt, grads)
        np.testing.assert_allclose(pt.predict_batch(x), jt.predict_batch(x), rtol=1e-5, atol=1e-5)
        losses = [pt.train_batch(x, y)["loss"] for _ in range(6)]
        assert losses[-1] < losses[0]

    def test_resnet_tiny_dp8_global_batchnorm_matches_jax(self, resnet_run):
        jt, pt, grads, _x, _y = resnet_run
        _assert_trainers_agree(jt, pt, grads)
        # the first step's running statistics (they depend on the initial
        # weights only): the global batch's, moved with flax's momentum
        theirs_stats, mine_stats = resnet_run.stats1
        for path, theirs in jax.tree_util.tree_flatten_with_path(theirs_stats)[0]:
            np.testing.assert_allclose(_tree_get(mine_stats, path), np.asarray(theirs), rtol=1e-5, atol=1e-6,
                                       err_msg=str(path))
        theirs_logits, mine_logits = resnet_run.eval0
        np.testing.assert_allclose(mine_logits, theirs_logits, rtol=1e-5, atol=1e-5)

    def test_batch_statistics_are_the_global_batch_s(self, resnet_run):
        """The statistics of one step on eight data positions equal those
        of the same batch on one position, and not the first position's
        own rows' statistics."""
        _jt, _pt, _grads, x, y = resnet_run
        trainers = [ShardedTrainer(ResNetTiny(num_classes=4, dtype=torch.float32), np.zeros((16, 16, 3), np.float32),
                                   create_mesh({"data": n}, devices=["cpu"] * n), params=resnet_run.init)
                    for n in (8, 1)]
        local = ShardedTrainer(ResNetTiny(num_classes=4, dtype=torch.float32), np.zeros((16, 16, 3), np.float32),
                               create_mesh({"data": 1}, devices=["cpu"]), params=resnet_run.init)
        for t in trainers:
            t.train_batch(x, y)
        local.train_batch(x[:1], y[:1])
        key = "bn_init.running_mean"
        a, b, c = (t.batch_stats[key].full().numpy() for t in (*trainers, local))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        assert np.abs(a - c).max() > 1e-4

    def test_trained_variables_serve_through_cudaserver(self, resnet_run):
        _jt, pt, _grads, x, _y = resnet_run
        variables = pt.serving_variables()
        server = CudaServer(device="cpu", model="resnet_tiny", num_classes=4, dtype="float32",
                            input_shape=[16, 16, 3], max_batch_size=8, warmup=False,
                            variables=serialization.msgpack_restore(serialization.to_bytes(variables)))
        server.load()
        try:
            np.testing.assert_allclose(server.predict(x, []), pt.predict_batch(x), rtol=1e-5, atol=1e-5)
        finally:
            server.unload()

    def test_kernel_without_backward_raises_naming_it(self, monkeypatch):
        from seldon_core_tpu_torch.ops import kernels

        q = torch.zeros(1, 4, 1, 8, requires_grad=True)
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        with pytest.raises(RuntimeError, match=r"flash_attention \(K3\) has no backward"):
            kernels.flash_attention(q, q, q)


def _jax_loss(module, variables, x, y, mutable=False):
    from seldon_core_tpu.parallel.train import cross_entropy_loss as jax_ce

    if mutable:
        logits, _ = module.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        logits = module.apply(variables, jnp.asarray(x), train=True)
    return jax_ce(logits, jnp.asarray(y))


class _ResnetRun(tuple):
    init = eval0 = stats1 = None


@pytest.fixture(scope="module")
def resnet_run():
    """ResNetTiny trained two steps on a {"data": 8} mesh by both trainers
    from the JAX module's initial variables."""
    jt = JaxShardedTrainer(FlaxResNetTiny(num_classes=4, dtype=jnp.float32), np.zeros((16, 16, 3), np.float32),
                           jax_create_mesh({"data": 8}))
    var0 = {"params": jax.device_get(jt.params), "batch_stats": jax.device_get(jt.batch_stats)}
    init = resnet_params_from_flax(var0)
    pt = ShardedTrainer(ResNetTiny(num_classes=4, dtype=torch.float32), np.zeros((16, 16, 3), np.float32),
                        create_mesh({"data": 8}, devices=CPU8), params=init)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=(8,)).astype(np.int32)
    module = FlaxResNetTiny(num_classes=4, dtype=jnp.float32)
    grads = jax.grad(lambda p: _jax_loss(module, {"params": p, "batch_stats": var0["batch_stats"]}, x, y,
                                         mutable=True))(var0["params"])
    eval0 = (jt.predict_batch(x), pt.predict_batch(x))
    stats1 = None
    for _ in range(2):
        theirs, mine = jt.train_batch(x, y), pt.train_batch(x, y)
        assert mine["loss"] == pytest.approx(theirs["loss"], rel=1e-5)
        assert mine["accuracy"] == theirs["accuracy"] and np.isfinite(mine["loss"])
        if stats1 is None:
            stats1 = (jax.device_get(jt.batch_stats), pt.serving_variables()["batch_stats"])
    run = _ResnetRun((jt, pt, grads, x, y))
    run.init, run.eval0, run.stats1 = init, eval0, stats1
    return run
