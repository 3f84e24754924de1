"""The port's paged LM against the JAX package's, module by module.

The same flax ``TransformerLM`` init (carried across by
``lm_params_from_flax``), the same numpy pool, block tables, tokens and
positions go through JAX ``PagedTransformerLM.apply`` and the port's
``PagedTransformerLM``, on the kernel lane (``SELDON_TPU_PAGED_KERNEL=
force``: JAX's Pallas kernel in interpret mode, the port's plain
version) and on the gather lane (``0``).  ``write_kv`` is compared page
for page.

Tolerances: float32 logits and K/V within rtol = atol = 1e-5 (the order
of sums differs between XLA and PyTorch on the CPU); bfloat16 logits
within relative L2 2e-2 (the two frameworks round at different places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.paged import get_paged_lm_class
from seldon_core_tpu.models.paged import write_kv as jax_write_kv
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedTransformerLM, write_kv
from seldon_core_tpu_torch.models.transformer import TransformerLM

CFG = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=2, max_len=64)
PS = 8
NUM_PAGES = 20
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_REL_L2 = 2e-2


@pytest.fixture(scope="module")
def flax_params():
    lm = FlaxTransformerLM(dtype=jnp.float32, **CFG)
    return lm.init(jax.random.key(3), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def state_dict(flax_params):
    return lm_params_from_flax(flax_params)


def _pool(seed=0):
    rng = np.random.default_rng(seed)
    hd = CFG["d_model"] // CFG["num_heads"]
    shape = (CFG["num_layers"], NUM_PAGES, PS, CFG["num_heads"], hd)
    return rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)


def _decode_inputs(seed=1):
    rng = np.random.default_rng(seed)
    lengths = np.array([0, 1, 8, 9, 23, 31], np.int32)
    tables = rng.permutation(np.arange(1, NUM_PAGES))[: 6 * 3].reshape(6, 3).astype(np.int32)
    tokens = rng.integers(0, CFG["vocab_size"], size=(6, 1)).astype(np.int32)
    return tokens, lengths[:, None].copy(), tables, lengths


def _prefill_inputs(seed=2):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG["vocab_size"], size=(3, 20)).astype(np.int32)
    tables = rng.permutation(np.arange(1, NUM_PAGES))[:12].reshape(3, 4).astype(np.int32)
    tables[2, 2:] = 0  # a row whose later pages were never allocated
    positions = np.broadcast_to(np.arange(20), (3, 20)).copy()
    return tokens, positions, tables, np.zeros((3,), np.int32)


def _jax_apply(flax_params, dtype, inputs, pool):
    tokens, positions, tables, lengths = inputs
    module = get_paged_lm_class()(dtype=getattr(jnp, dtype), **CFG)
    logits, nk, nv = module.apply({"params": flax_params}, jnp.asarray(tokens), jnp.asarray(positions),
                                  jnp.asarray(pool[0], getattr(jnp, dtype)), jnp.asarray(pool[1], getattr(jnp, dtype)),
                                  jnp.asarray(tables), jnp.asarray(lengths))
    return [np.asarray(a, np.float32) for a in (logits, nk, nv)]


def _port_apply(state_dict, dtype, inputs, pool, use_kernel):
    tokens, positions, tables, lengths = inputs
    dt = getattr(torch, dtype)
    lm = PagedTransformerLM(dtype=dt, **CFG)
    lm.load_state_dict(state_dict)
    with torch.inference_mode():
        out = lm(torch.from_numpy(tokens), torch.from_numpy(positions), torch.from_numpy(pool[0]).to(dt),
                 torch.from_numpy(pool[1]).to(dt), torch.from_numpy(tables), torch.from_numpy(lengths),
                 use_kernel=use_kernel)
    return [a.float().numpy() for a in out]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class TestConvert:
    def test_consumes_the_whole_tree_and_loads(self, flax_params, state_dict):
        lm = TransformerLM(dtype=torch.float32, **CFG)
        missing, unexpected = lm.load_state_dict(state_dict, strict=True), None
        assert not missing.missing_keys and not missing.unexpected_keys and unexpected is None
        n_leaves = len(jax.tree_util.tree_leaves(flax_params))
        assert len(state_dict) == n_leaves == len(lm.state_dict())
        np.testing.assert_array_equal(state_dict["blocks.1.qkv.weight"].numpy(),
                                      np.asarray(flax_params["block_1"]["qkv"]["kernel"]).T)
        np.testing.assert_array_equal(state_dict["ln_f.weight"].numpy(),
                                      np.asarray(flax_params["LayerNorm_0"]["scale"]))

    def test_accepts_the_variables_wrapper(self, flax_params, state_dict):
        wrapped = lm_params_from_flax({"params": flax_params})
        assert wrapped.keys() == state_dict.keys()

    def test_extra_and_missing_leaves_raise(self, flax_params):
        extra = jax.tree_util.tree_map(lambda x: x, flax_params)
        extra = dict(extra, stray={"kernel": np.zeros((2, 2), np.float32)})
        with pytest.raises(ValueError, match="unconverted flax entries"):
            lm_params_from_flax(extra)
        missing = dict(flax_params)
        missing.pop("head")
        with pytest.raises(ValueError, match="missing head"):
            lm_params_from_flax(missing)

    def test_seeded_init_follows_flax_scales(self):
        from seldon_core_tpu_torch.models.generate import load_lm_params

        a = load_lm_params("", CFG, seed=4)
        b = load_lm_params("", CFG, seed=4)
        assert all(torch.equal(a[k], b[k]) for k in a)
        w = a["blocks.0.mlp_in.weight"]
        std = (1 / CFG["d_model"]) ** 0.5
        assert w.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6
        assert abs(float(w.std()) - std) < 0.25 * std
        assert float(a["blocks.0.mlp_in.bias"].abs().max()) == 0.0
        assert torch.equal(a["ln_f.weight"], torch.ones(CFG["d_model"]))


class TestWriteKv:
    @pytest.mark.parametrize("case", ["decode", "prefill", "segment"])
    def test_matches_jax_page_for_page(self, case):
        rng = np.random.default_rng(5)
        L, h, hd = 2, 2, 4
        pk = rng.normal(size=(L, NUM_PAGES, PS, h, hd)).astype(np.float32)
        pv = rng.normal(size=(L, NUM_PAGES, PS, h, hd)).astype(np.float32)
        B = 5
        tables = rng.permutation(np.arange(1, NUM_PAGES))[: B * 3].reshape(B, 3).astype(np.int32)
        tables[4, 1:] = 0
        S = {"decode": 1, "prefill": 20, "segment": 3}[case]
        new_k = rng.normal(size=(L, B, S, h, hd)).astype(np.float32)
        new_v = rng.normal(size=(L, B, S, h, hd)).astype(np.float32)
        start = np.array([0, 5, 8, 21, 40], np.int32) if case != "prefill" else np.zeros(B, np.int32)
        valid = rng.random((B, S)) < 0.7
        kw = dict(page_size=PS, max_len=24, from_zero=case == "prefill")
        jk, jv = jax_write_kv(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(new_k), jnp.asarray(new_v),
                              jnp.asarray(tables), jnp.asarray(start), jnp.asarray(valid), **kw)
        tk, tv = write_kv(torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy()), torch.from_numpy(new_k),
                          torch.from_numpy(new_v), torch.from_numpy(tables), torch.from_numpy(start),
                          torch.from_numpy(valid), **kw)
        # page 0 is the trash page: which of several writes lands there is
        # unspecified, and nothing reads it
        np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
        np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])
        assert not np.array_equal(tk.numpy()[:, 1:], pk[:, 1:])  # something was written


@pytest.fixture(scope="module")
def jax_results(flax_params):
    """JAX's (logits, K, V) per (phase, lane, dtype); the kernel lane runs
    the Pallas kernel in interpret mode."""
    import os

    out = {}
    before = os.environ.get("SELDON_TPU_PAGED_KERNEL")
    try:
        for lane in ("force", "0"):
            os.environ["SELDON_TPU_PAGED_KERNEL"] = lane
            for dtype in ("float32", "bfloat16"):
                out["decode", lane, dtype] = _jax_apply(flax_params, dtype, _decode_inputs(), _pool())
        os.environ["SELDON_TPU_PAGED_KERNEL"] = "0"
        for dtype in ("float32", "bfloat16"):
            out["prefill", dtype] = _jax_apply(flax_params, dtype, _prefill_inputs(), _pool())
    finally:
        if before is None:
            os.environ.pop("SELDON_TPU_PAGED_KERNEL", None)
        else:
            os.environ["SELDON_TPU_PAGED_KERNEL"] = before
    return out


class TestPagedLM:
    @pytest.mark.parametrize("lane", ["force", "0"])
    def test_decode_step_f32(self, state_dict, jax_results, lane):
        got = _port_apply(state_dict, "float32", _decode_inputs(), _pool(), use_kernel=lane == "force")
        for g, r in zip(got, jax_results["decode", lane, "float32"]):
            np.testing.assert_allclose(g, r, **F32)

    @pytest.mark.parametrize("lane", ["force", "0"])
    def test_decode_step_bf16(self, state_dict, jax_results, lane):
        got = _port_apply(state_dict, "bfloat16", _decode_inputs(), _pool(), use_kernel=lane == "force")
        ref = jax_results["decode", lane, "bfloat16"]
        assert np.isfinite(got[0]).all()
        assert _rel_l2(got[0], ref[0]) <= BF16_REL_L2

    def test_prefill_f32(self, state_dict, jax_results):
        got = _port_apply(state_dict, "float32", _prefill_inputs(), _pool(), use_kernel=False)
        for g, r in zip(got, jax_results["prefill", "float32"]):
            np.testing.assert_allclose(g, r, **F32)

    def test_prefill_bf16(self, state_dict, jax_results):
        got = _port_apply(state_dict, "bfloat16", _prefill_inputs(), _pool(), use_kernel=False)
        assert _rel_l2(got[0], jax_results["prefill", "bfloat16"][0]) <= BF16_REL_L2

    def test_kernel_and_gather_lanes_agree(self, state_dict):
        a = _port_apply(state_dict, "float32", _decode_inputs(), _pool(), use_kernel=True)
        b = _port_apply(state_dict, "float32", _decode_inputs(), _pool(), use_kernel=False)
        np.testing.assert_allclose(a[0], b[0], **F32)
        np.testing.assert_array_equal(a[0].argmax(-1), b[0].argmax(-1))

    def test_prefill_equals_the_plain_lm(self, state_dict):
        """A from-zero paged prefill is the causal LM over the prompt."""
        tokens, positions, tables, lengths = _prefill_inputs()
        paged = _port_apply(state_dict, "float32", (tokens, positions, tables, lengths), _pool(), use_kernel=False)
        lm = TransformerLM(dtype=torch.float32, **CFG)
        lm.load_state_dict(state_dict)
        with torch.inference_mode():
            plain = lm(torch.from_numpy(tokens)).numpy()
        np.testing.assert_allclose(paged[0], plain, **F32)

    def test_select_keeps_the_rows_of_the_full_call(self, state_dict):
        tokens, positions, tables, lengths = _prefill_inputs()
        lm = PagedTransformerLM(dtype=torch.float32, **CFG)
        lm.load_state_dict(state_dict)
        pk, pv = (torch.from_numpy(a) for a in _pool())
        args = (torch.from_numpy(tokens), torch.from_numpy(positions), pk, pv, torch.from_numpy(tables),
                torch.from_numpy(lengths))
        with torch.inference_mode():
            full = lm(*args)[0]
            last = torch.tensor([19, 4, 11])
            sel = lm(*args, select=last)[0]
        np.testing.assert_allclose(sel[:, 0].numpy(), full[torch.arange(3), last].numpy(), **F32)
