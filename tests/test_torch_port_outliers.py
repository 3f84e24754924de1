"""The port's outlier detectors against the JAX package's.

* ``OUTLIER_VAE``: with the JAX detector's weights (``vae_params_from_flax``)
  and JAX's latent noise, scores equal to 1e-5; one Adam step (optax's
  defaults against ``torch.optim.Adam``) moves every weight alike to
  1e-5; the port's own noise is a ``torch.Generator`` seeded 0 (C23); a
  port checkpoint is a flax msgpack the JAX detector reads.
* ``OUTLIER_MAHALANOBIS``: the same scores over a stream, and its state.
* ``OUTLIER_ISOLATION_FOREST``: a seed packs the same forest, and the
  device scoring equals the JAX scoring to 1e-6.
* ``OUTLIER_SEQ2SEQ``: with converted LSTM weights
  (``seq2seq_params_from_flax``) scores equal to 1e-5.

Then the JAX suite's behaviour checks (``tests/test_components.py``) on
the port: fitting converges, outliers score higher and tag, the
detectors pass data through as transformers, and their names resolve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization as flax_serialization

from seldon_core_tpu.components import outliers as jax_outliers
from seldon_core_tpu_torch.components.outliers import (
    IsolationForestDetector,
    MahalanobisDetector,
    Seq2SeqOutlierDetector,
    VAEOutlierDetector,
)
from seldon_core_tpu_torch.engine import units
from seldon_core_tpu_torch.models.convert import seq2seq_params_from_flax, vae_params_from_flax


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rows(n=24, d=5, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_vae():
    det = jax_outliers.VAEOutlierDetector(latent_dim=2, hidden_dim=16, seed=3)
    det._build(5)
    return det


def _port_vae(jax_det):
    det = VAEOutlierDetector(latent_dim=2, hidden_dim=16, device="cpu")
    det.load_flax(_numpy(jax_det.params))
    return det


class TestVAE:
    def test_scores_equal_jax_with_jaxs_noise(self, jax_vae):
        X = np.concatenate([_rows(12), np.full((4, 5), 3.0, np.float32)])
        eps = np.asarray(jax.random.normal(jax.random.key(0), (len(X), 2)))
        np.testing.assert_allclose(_port_vae(jax_vae).score(X, eps=eps), jax_vae.score(X), rtol=1e-5, atol=1e-7)

    def test_the_ports_noise_is_a_generator_seeded_zero(self, jax_vae):
        det = _port_vae(jax_vae)
        X = _rows(6)
        want = torch.randn((6, 2), generator=torch.Generator().manual_seed(0)).numpy()
        np.testing.assert_array_equal(det.score_noise(6).numpy(), want)
        np.testing.assert_array_equal(det.score(X), det.score(X, eps=want))

    def test_one_adam_step_equals_optax(self, jax_vae):
        batch = _rows(16)
        rng = jax.random.key(7)
        module, params = jax_vae.module, jax_vae.params
        tx = optax.adam(1e-2)

        def loss_fn(p):
            recon, mu, logvar = module.apply(p, batch, rng)
            kl = -0.5 * jnp.mean(1 + logvar - mu ** 2 - jnp.exp(logvar))
            return jnp.mean((batch - recon) ** 2) + 1e-3 * kl

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = tx.update(grads, tx.init(params))
        stepped = optax.apply_updates(params, updates)

        det = _port_vae(jax_vae)
        eps = torch.from_numpy(np.array(jax.random.normal(rng, (16, 2))))
        got = det.train_step(det.make_optimizer(1e-2), torch.from_numpy(batch), eps, 1e-3)
        assert got == pytest.approx(float(loss), rel=1e-5)
        want = vae_params_from_flax(_numpy(stepped))
        for key, value in det.module.state_dict().items():
            np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-6, err_msg=key)

    def test_fit_detect_and_a_checkpoint_jax_reads(self, tmp_path, jax_vae):
        rng = np.random.default_rng(0)
        normal = rng.normal(size=(256, 4)).astype(np.float32) * 0.1
        det = VAEOutlierDetector(latent_dim=2, hidden_dim=16, seed=0, device="cpu")
        losses = det.fit(normal, epochs=60)
        assert losses[-1] < losses[0]
        normal_scores = det.score(normal[:16])
        assert det.score(np.full((4, 4), 8.0, np.float32)).mean() > normal_scores.mean() * 10
        det.threshold = float(normal_scores.max() * 5)
        det.score(np.full((1, 4), 8.0, np.float32))
        assert det.tags() == {"outlier": True, "outlier_count": 1}
        assert {m["key"] for m in det.metrics()} == {"outlier_score_max", "outliers_total"}

        path = str(tmp_path / "vae.msgpack")
        det.save(path)
        fresh = VAEOutlierDetector(n_features=4, latent_dim=2, hidden_dim=16, model_uri=path, device="cpu")
        fresh.load()
        np.testing.assert_allclose(fresh.score(normal[:8]), det.score(normal[:8]), rtol=1e-6)
        theirs = jax_outliers.VAEOutlierDetector(n_features=4, latent_dim=2, hidden_dim=16, model_uri=path)
        theirs.load()
        eps = np.asarray(jax.random.normal(jax.random.key(0), (8, 2)))
        np.testing.assert_allclose(det.score(normal[:8], eps=eps), theirs.score(normal[:8]), rtol=1e-5)

    def test_a_jax_checkpoint_loads_by_model_uri(self, tmp_path, jax_vae):
        path = tmp_path / "jax_vae.msgpack"
        path.write_bytes(flax_serialization.to_bytes(jax_vae.params))
        det = VAEOutlierDetector(n_features=5, latent_dim=2, hidden_dim=16, model_uri=str(path), device="cpu")
        det.load()
        for key, value in vae_params_from_flax(_numpy(jax_vae.params)).items():
            np.testing.assert_array_equal(det.module.state_dict()[key].numpy(), value.numpy())


class TestMahalanobis:
    def test_scores_and_state_equal_jax(self):
        mine, theirs = MahalanobisDetector(min_samples=5), jax_outliers.MahalanobisDetector(min_samples=5)
        X = np.concatenate([_rows(40), np.full((2, 5), 9.0, np.float32)])
        for chunk in np.array_split(X, 5):
            np.testing.assert_allclose(mine.score(chunk), theirs.score(chunk), rtol=1e-6, atol=1e-9)
        assert mine.tags() == theirs.tags() and mine.tags()["outlier"] is True
        a, b = mine.checkpoint_state(), theirs.checkpoint_state()
        assert a["n"] == b["n"] and a["total_outliers"] == b["total_outliers"]
        restored = MahalanobisDetector(min_samples=5)
        restored.restore_state(a)
        np.testing.assert_array_equal(restored.score(X[:3]), mine.score(X[:3]))

    def test_as_transformer_passes_data_through(self):
        det = MahalanobisDetector(min_samples=2)
        X = _rows(8)
        assert det.transform_input(X, []) is X and det.predict(X, []).shape == (8, 1)


class TestIsolationForest:
    def test_same_forest_and_scores_as_jax(self):
        X = _rows(128, 4, seed=1)
        mine = IsolationForestDetector(n_trees=25, subsample=64, seed=5, device="cpu").fit(X)
        theirs = jax_outliers.IsolationForestDetector(n_trees=25, subsample=64, seed=5).fit(X)
        for key in ("features", "thresholds", "left", "right", "node_size"):
            np.testing.assert_array_equal(getattr(mine, key), getattr(theirs, key))
        Y = np.concatenate([X[:16], np.full((4, 4), 6.0, np.float32)])
        np.testing.assert_allclose(mine.score(Y), theirs.score(Y), rtol=0, atol=1e-6)
        assert mine.score(Y)[-4:].min() > mine.score(Y)[:16].max()

    def test_state_roundtrip_and_unfitted(self):
        X = _rows(64, 4, seed=2)
        det = IsolationForestDetector(n_trees=10, subsample=32, device="cpu").fit(X)
        fresh = IsolationForestDetector(device="cpu")
        with pytest.raises(RuntimeError, match="fit"):
            fresh.score(X)
        fresh.restore_state(det.checkpoint_state())
        np.testing.assert_array_equal(fresh.score(X[:8]), det.score(X[:8]))
        assert det.transform_input(X, []) is X and det.class_names() == ["anomaly_score"]


class TestSeq2Seq:
    def test_scores_equal_jax_with_converted_weights(self):
        theirs = jax_outliers.Seq2SeqOutlierDetector(hidden_dim=8, seed=2)
        theirs._build(3)
        mine = Seq2SeqOutlierDetector(hidden_dim=8, device="cpu")
        mine.load_flax(_numpy(theirs.params))
        S = np.random.default_rng(4).normal(size=(6, 9, 3)).astype(np.float32)
        np.testing.assert_allclose(mine.score(S), theirs.score(S), rtol=1e-5, atol=1e-7)
        state = seq2seq_params_from_flax(_numpy(theirs.params))
        assert not state["encoder.bias_ih_l0"].any()

    def test_fit_detects_and_jax_reads_the_checkpoint(self, tmp_path):
        t = np.linspace(0, 4 * np.pi, 16)
        rng = np.random.default_rng(0)
        normal = np.stack([np.sin(t + p) for p in rng.uniform(0, 2 * np.pi, 64)]).astype(np.float32)
        det = Seq2SeqOutlierDetector(hidden_dim=16, seed=0, device="cpu")
        losses = det.fit(normal, epochs=30)
        assert losses[-1] < losses[0]
        odd = rng.normal(size=(4, 16)).astype(np.float32) * 2
        assert det.score(odd).mean() > det.score(normal[:8]).mean()
        path = str(tmp_path / "s2s.msgpack")
        det.save(path)
        theirs = jax_outliers.Seq2SeqOutlierDetector(n_features=1, hidden_dim=16, model_uri=path)
        theirs.load()
        np.testing.assert_allclose(det.score(normal[:8]), theirs.score(normal[:8]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name,cls", [("OUTLIER_MAHALANOBIS", MahalanobisDetector),
                                      ("OUTLIER_VAE", VAEOutlierDetector),
                                      ("OUTLIER_ISOLATION_FOREST", IsolationForestDetector),
                                      ("OUTLIER_SEQ2SEQ", Seq2SeqOutlierDetector)])
def test_registered_under_the_jax_names(name, cls):
    assert units._lookup_builtin(name) is cls


def test_asking_for_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from seldon_core_tpu_torch.runtime import MicroserviceError

    for cls in (VAEOutlierDetector, IsolationForestDetector, Seq2SeqOutlierDetector):
        with pytest.raises(MicroserviceError):
            cls()
