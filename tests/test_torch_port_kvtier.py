"""The port's KV tier (``models/kvtier.py`` and the engine's demote / promote
path) against the JAX package's.

``HostKvTier`` takes the same operation sequence in both packages (puts
over a byte budget, pops with identity misses, discards, a spill
directory, a restart's rescan, a corrupted spill file, the audit) and
answers alike: return values, keys, stats, evictions, files and audit
findings.  At the engine level the churn run of
``tests/test_kv_tier.py:179`` (two 40-token sessions through a pool that
holds one, two rounds, ``SELDON_TPU_PAGED_DEBUG=1``) runs on a port
engine with ``SELDON_TPU_KV_OFFLOAD=1`` and with it off and on the JAX
engine with it on, all in float32 from one flax init, on the pool chunk
with the kernel lane forced (the JAX engine's split pool, so a demoted
page's container has the port's bytes): the greedy tokens
are equal across the three (and equal a never-evicting pool's), and
every ``kv_tier_*`` counter equals the JAX engine's.  A small host
budget with a spill directory promotes from disk with the same tokens.
With the tier off the ``kv_tier_*`` keys are shed from ``engine_stats``.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_core_tpu.codec.bufview import pack_kv_handoff as jax_pack_kv_handoff
from seldon_core_tpu.codec.tensor import PayloadError as JaxPayloadError
from seldon_core_tpu.models import kvtier as jax_kvtier
from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu_torch.codec.bufview import pack_kv_handoff
from seldon_core_tpu_torch.codec.tensor import PayloadError
from seldon_core_tpu_torch.models import kvtier
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine

CFG = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2, max_len=128)
ENGINE = dict(page_size=8, max_slots=1, steps_per_call=4)
TIER_KEYS = ("kv_tier_demotions", "kv_tier_promotions", "kv_tier_host_hits", "kv_tier_disk_hits",
             "kv_tier_misses", "kv_tier_evictions", "kv_tier_bytes_demoted", "kv_tier_bytes_promoted",
             "kv_tier_host_bytes", "kv_tier_disk_bytes")
OTHER_KEYS = ("prefix_hits", "prefix_misses", "prefix_evictions", "prefix_tokens_saved", "completed", "evictions")


@contextlib.contextmanager
def _env(**kv):
    before = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def flax_params():
    return FlaxTransformerLM(dtype=jnp.float32, **CFG).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


def _sessions(n=2, tokens=40, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], size=(tokens,)).astype(np.int32) for _ in range(n)]


def _container(pack, tokens, seed=0):
    tokens = np.asarray(tokens, np.int32)
    rng = np.random.default_rng(seed)
    shape = (1, 1, len(tokens), 2, 8)
    return pack({"prompt": tokens, "last_logits": np.zeros((1,), np.float32),
                 "k": rng.normal(size=shape).astype(np.float32), "v": rng.normal(size=shape).astype(np.float32)})


# ---------------------------------------------------------------- the tier alone

def _tier_script(mod, pack, spill_dir):
    """One operation sequence; every answer the tier gives, in order."""
    toks = tuple(range(8))
    blob = _container(pack, toks)
    other = tuple(range(1, 9))
    out = []

    def pop(tier, key, parent, tokens):
        got = tier.pop(key, parent, tokens)
        return None if got is None else (got[1] == blob or len(got[1]), got[2],
                                         tuple(int(t) for t in got[0]["prompt"]))

    host = mod.HostKvTier(budget_bytes=int(len(blob) * 2.5))
    out.append([host.put(k, 0, toks, blob) for k in (1, 2, 3, 4)])  # the budget drops the oldest
    out.append((sorted(host.keys()), host.stats(), host.audit()))
    out.append([pop(host, 1, 0, toks), pop(host, 3, 9, toks), pop(host, 3, 0, other), pop(host, 3, 0, toks)])
    host.discard(4)
    out.append((sorted(host.keys()), host.stats()))
    disk = mod.HostKvTier(budget_bytes=0, spill_dir=spill_dir, spill_budget_bytes=int(len(blob) * 2.5))
    out.append([disk.put(k, k + 100, toks, blob) for k in (5, 6, -7)])  # a negative key's file name
    out.append((sorted(disk.keys()), disk.stats(), sorted(os.listdir(spill_dir))))
    reborn = mod.HostKvTier(budget_bytes=1 << 20, spill_dir=spill_dir, spill_budget_bytes=1 << 20)
    out.append((sorted(reborn.keys()), reborn.stats()))
    out.append([pop(reborn, 6, 106, other), pop(reborn, 6, 106, toks), pop(reborn, 6, 106, toks)])
    path = os.path.join(spill_dir, sorted(n for n in os.listdir(spill_dir) if n.startswith("kv_"))[0])
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) - 9] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    try:
        reborn.pop(-7, 93, toks)
        out.append("no error")
    except (PayloadError, JaxPayloadError) as exc:
        out.append(str(exc))
    out.append((sorted(reborn.keys()), reborn.stats(), reborn.audit()))
    reborn._host_bytes += 1
    out.append(reborn.audit())
    return out


def test_host_kv_tier_answers_as_jax(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _tier_script(kvtier, pack_kv_handoff, str(tmp_path / "port"))
    want = _tier_script(jax_kvtier, jax_pack_kv_handoff, str(tmp_path / "jax"))
    assert got == want
    assert any("drifted" in p for p in got[-1])


def test_host_kv_tier_reads_the_jax_packages_spill_files(tmp_path):
    toks = tuple(range(8))
    blob = _container(jax_pack_kv_handoff, toks)
    jax_kvtier.HostKvTier(budget_bytes=0, spill_dir=str(tmp_path), spill_budget_bytes=1 << 20).put(5, 2, toks, blob)
    payload, got, level = kvtier.HostKvTier(budget_bytes=0, spill_dir=str(tmp_path),
                                            spill_budget_bytes=1 << 20).pop(5, 2, toks)
    assert level == "disk" and got == blob
    np.testing.assert_array_equal(payload["prompt"], np.asarray(toks))


# ---------------------------------------------------------------- the engines

def _churn(make, rounds=2, new=6):
    eng = make()
    a, b = _sessions()
    outs = [np.asarray(eng.generate(p, max_new_tokens=new)).tolist() for _ in range(rounds) for p in (a, b)]
    return outs, eng.engine_stats()


def _port(params, offload, **kw):
    def make():
        with _env(SELDON_TPU_KV_OFFLOAD=offload, SELDON_TPU_PAGED_DEBUG="1", SELDON_TPU_PAGED_KERNEL="force"):
            return PagedEngine(params, dtype="float32", device="cpu", **CFG, **{**ENGINE, **kw})
    return make


def _jax(flax_params, offload, **kw):
    def make():
        with _env(SELDON_TPU_KV_OFFLOAD=offload, SELDON_TPU_PAGED_DEBUG="1", SELDON_TPU_PAGED_KERNEL="force"):
            return jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **{**ENGINE, **kw})
    return make


@pytest.fixture(scope="module")
def churn_runs(params, flax_params):
    return {
        "port_on": _churn(_port(params, "1", num_pages=8)),
        "port_off": _churn(_port(params, "0", num_pages=8)),
        "port_never": _churn(_port(params, "0")),
        "jax_on": _churn(_jax(flax_params, "1", num_pages=8)),
    }


def test_churn_tokens_equal_with_the_tier_on_and_off(churn_runs):
    on = churn_runs["port_on"][0]
    assert on == churn_runs["port_off"][0] == churn_runs["port_never"][0] == churn_runs["jax_on"][0]


def test_churn_tier_counters_equal_the_jax_engines(churn_runs):
    got, want = churn_runs["port_on"][1], churn_runs["jax_on"][1]
    for key in TIER_KEYS + OTHER_KEYS:
        assert got[key] == want[key], key
    assert got["kv_tier_demotions"] > 0 and got["kv_tier_promotions"] > 0 and got["kv_tier_host_hits"] > 0
    assert got["kv_tier_bytes_promoted"] > 0 and got["kv_tier_host_bytes"] > 0


def test_engine_stats_shed_the_tier_keys_when_off(churn_runs):
    assert not any(k.startswith("kv_tier_") for k in churn_runs["port_off"][1])
    assert set(TIER_KEYS) <= set(churn_runs["port_on"][1])


def test_spill_directory_promotes_from_disk(params, flax_params, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    outs, stats = {}, {}
    for name, make, where in (("port", _port, tmp_path / "port"), ("jax", _jax, tmp_path / "jax")):
        # a host budget below one container: every demotion spills to disk
        with _env(SELDON_TPU_KV_HOST_BUDGET_GIB="1e-9", SELDON_TPU_KV_SPILL_DIR=str(where)):
            outs[name], stats[name] = _churn((make(params, "1", num_pages=8) if name == "port"
                                              else make(flax_params, "1", num_pages=8)))
    assert outs["port"] == outs["jax"] == _churn(_port(params, "0"))[0]
    assert stats["port"]["kv_tier_disk_hits"] > 0 and stats["port"]["kv_tier_host_hits"] == 0
    for key in TIER_KEYS:
        assert stats["port"][key] == stats["jax"][key], key


def test_promotion_re_registers_the_chain_and_the_audit_names_a_double_key(params):
    eng = _port(params, "1", num_pages=8)()
    a, b = _sessions()
    for p in (a, b, a):
        eng.generate(p, max_new_tokens=6)
    with eng._lock:
        hbm = set(eng._prefix_index)
        eng._check_invariants_locked()
    assert not (eng._kv_tier.keys() & hbm) and eng.engine_stats()["kv_tier_promotions"] >= 1
    key = next(iter(hbm))
    toks = tuple(range(8))
    eng._kv_tier.put(key, 0, toks, _container(pack_kv_handoff, toks))
    with eng._lock, pytest.raises(RuntimeError, match="AND the KV tier"):
        eng._check_invariants_locked()


def test_a_dying_streams_promotion_goes_back_to_the_tier(params):
    eng = _port(params, "1", num_pages=8)()
    a, b = _sessions()
    eng.generate(a, max_new_tokens=6)
    eng.generate(b, max_new_tokens=6)  # reclaims a's chain into the tier
    eng.step()  # nothing queued: the demotions flush at the next write
    before = eng._kv_tier.keys()
    s = eng.submit(a, max_new_tokens=6)
    with eng._lock:
        admitted = eng._admit_locked()
    assert admitted and s.tier_promote is not None
    eng.fail_all(RuntimeError("gone"))
    assert s.tier_promote is None and eng._kv_tier.keys() == before
