"""The port's KV-page handoff and migration containers against the JAX package's.

``seldon_core_tpu_torch/codec/bufview.py`` ports the CRC32C trailer and the
two KV containers of ``seldon_core_tpu/codec/bufview.py:416-856``.  The
same numpy-seeded payloads (float32 and int8 pools, a bfloat16 one, the
checksum knob on and off) pack to the same bytes in both packages, each
package opens the other's containers to the same arrays, ``crc32c``
equals the JAX one through the table loop and through the native
``srt1_crc32c``, a flipped byte raises ``PayloadError`` naming the
trailer, and malformed containers raise the JAX package's messages word
for word.  Exact throughout: bytes and arrays compare equal.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from seldon_core_tpu.codec import bufview as jax_bufview
from seldon_core_tpu.codec.tensor import PayloadError as JaxPayloadError
from seldon_core_tpu_torch.codec import bufview
from seldon_core_tpu_torch.codec.tensor import PayloadError
from seldon_core_tpu_torch.native import available as native_available

L, PS, H, HD, VOCAB = 2, 8, 2, 4, 64


def _payload(pool: str, kind: str, plen: int = 20, decoded: int = 5, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    total = plen + (decoded if kind == "migration" else 0)
    pages = -(-total // PS)
    shape = (L, pages, PS, H, HD)
    if pool == "int8":
        k = rng.integers(-127, 128, size=shape).astype(np.int8)
        v = rng.integers(-127, 128, size=shape).astype(np.int8)
    else:
        k = rng.normal(size=shape).astype(np.float32)
        v = rng.normal(size=shape).astype(np.float32)
    out = {"prompt": rng.integers(0, VOCAB, plen).astype(np.int32),
           "last_logits": rng.normal(size=VOCAB).astype(np.float32), "k": k, "v": v,
           "page_size": PS, "layout": "split"}
    if pool == "int8":
        out["k_scales"] = rng.random((L, pages)).astype(np.float32)
        out["v_scales"] = rng.random((L, pages)).astype(np.float32)
    if kind == "migration":
        out.update(tokens=rng.integers(0, VOCAB, decoded).astype(np.int32),
                   key_data=rng.integers(0, 2 ** 32, 4, dtype=np.uint64).astype(np.uint32), req_id=7,
                   max_new_tokens=16, temperature=0.5, top_k=3, eos_id=-1, seed=11, priority=2,
                   deadline_remaining_ms=1234.5, streamed=3, stream_tokens=True, adapter="a1", pending=None)
    return out


PACK = {"handoff": (bufview.pack_kv_handoff, jax_bufview.pack_kv_handoff),
        "migration": (bufview.pack_kv_migration, jax_bufview.pack_kv_migration)}
UNPACK = {"handoff": (bufview.unpack_kv_handoff, jax_bufview.unpack_kv_handoff),
          "migration": (bufview.unpack_kv_migration, jax_bufview.unpack_kv_migration)}


@pytest.fixture
def checksum(monkeypatch, request):
    monkeypatch.setenv("SELDON_TPU_KV_CHECKSUM", request.param)
    return request.param == "1"


# ---------------------------------------------------------------- CRC32C

@pytest.mark.parametrize("n", [0, 1, 7, 8, 1000, 65537])
def test_crc32c_equals_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    want = jax_bufview._crc32c_py(data)
    assert bufview._crc32c_py(data) == want
    assert bufview.crc32c(data) == want == jax_bufview.crc32c(data)
    assert bufview.crc32c(data[n // 2:], bufview.crc32c(data[: n // 2])) == want  # chained


def test_crc32c_known_vector_and_native_binding():
    assert bufview.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    # the native srt1_crc32c runs where the library builds (the table loop
    # is the same polynomial otherwise)
    assert bufview.crc32c_impl() == ("native" if native_available() else "table")
    if native_available():
        from seldon_core_tpu_torch.native import get_lib

        data = bytes(range(256)) * 41
        assert get_lib().srt1_crc32c(data, len(data), 0) == bufview._crc32c_py(data)


# ---------------------------------------------------------------- byte parity

@pytest.mark.parametrize("checksum", ["1", "0"], indirect=True)
@pytest.mark.parametrize("pool", ["float32", "int8"])
@pytest.mark.parametrize("kind", ["handoff", "migration"])
def test_containers_byte_equal_to_jax(kind, pool, checksum):
    payload = _payload(pool, kind)
    mine, theirs = (pack(payload) for pack in PACK[kind])
    assert mine == theirs
    trailer = mine[-8:-4] == b"SRTC"
    assert trailer == checksum


@pytest.mark.parametrize("kind", ["handoff", "migration"])
def test_bfloat16_pages_frame_as_jax(kind):
    payload = _payload("float32", kind)
    for name in ("k", "v"):
        payload[name] = payload[name].astype(ml_dtypes.bfloat16)
    theirs = PACK[kind][1](payload)
    # the port's pool hands bfloat16 tensors over; their words frame as code 5
    port = dict(payload)
    for name in ("k", "v"):
        port[name] = torch.from_numpy(payload[name].view(np.int16).copy()).view(torch.bfloat16)
    assert PACK[kind][0](port) == theirs
    assert PACK[kind][0](payload) == theirs
    got = UNPACK[kind][0](theirs)
    assert got["k"].dtype == torch.bfloat16 and torch.equal(got["k"], port["k"])
    assert torch.equal(got["v"], port["v"])


@pytest.mark.parametrize("pool", ["float32", "int8"])
@pytest.mark.parametrize("kind", ["handoff", "migration"])
def test_each_package_opens_the_others_container(kind, pool):
    payload = _payload(pool, kind, seed=3)
    port_pack, jax_pack = PACK[kind]
    port_unpack, jax_unpack = UNPACK[kind]
    for blob, unpack in ((jax_pack(payload), port_unpack), (port_pack(payload), jax_unpack)):
        got = unpack(blob)
        names = ["prompt", "last_logits", "k", "v"] + (["k_scales", "v_scales"] if pool == "int8" else [])
        if kind == "migration":
            names += ["tokens", "key_data"]
        for name in names:
            np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(payload[name]))
            assert np.asarray(got[name]).dtype == np.asarray(payload[name]).dtype
        assert got["page_size"] == PS and got["layout"] == "split"
        if kind == "migration":
            for field in ("req_id", "max_new_tokens", "temperature", "top_k", "eos_id", "seed", "priority",
                          "deadline_remaining_ms", "streamed", "stream_tokens", "adapter", "pending"):
                assert got[field] == payload[field], field
    # and the two decodings agree key for key
    assert sorted(port_unpack(jax_pack(payload))) == sorted(jax_unpack(jax_pack(payload)))


# ---------------------------------------------------------------- the trailer

@pytest.mark.parametrize("kind", ["handoff", "migration"])
def test_flipped_byte_raises_naming_the_trailer(kind):
    blob = bytearray(PACK[kind][0](_payload("float32", kind)))
    blob[len(blob) // 2] ^= 0x40
    for unpack, err in ((UNPACK[kind][0], PayloadError), (UNPACK[kind][1], JaxPayloadError)):
        with pytest.raises(err, match=rf"CRC32C mismatch at trailer offset {len(blob) - 8}"):
            unpack(bytes(blob))


def test_knob_off_skips_the_trailer_both_ways(monkeypatch):
    payload = _payload("float32", "handoff")
    with_trailer = bufview.pack_kv_handoff(payload)
    monkeypatch.setenv("SELDON_TPU_KV_CHECKSUM", "0")
    bare = bufview.pack_kv_handoff(payload)
    assert len(bare) + 8 >= len(with_trailer) > len(bare)
    # off: a trailer is stripped unverified, even a wrong one
    bad = bytearray(with_trailer)
    bad[-1] ^= 0xFF
    np.testing.assert_array_equal(bufview.unpack_kv_handoff(bytes(bad))["k"], payload["k"])
    monkeypatch.setenv("SELDON_TPU_KV_CHECKSUM", "1")
    # on: a container without a trailer is still read (mixed fleets)
    np.testing.assert_array_equal(bufview.unpack_kv_handoff(bare)["k"], payload["k"])


# ---------------------------------------------------------------- malformed

def _drop(payload, name):
    out = dict(payload)
    out.pop(name)
    return out


def _pack_malformed(case):
    """``(kind, pack-side?, payload or raw bytes)`` of each malformed case."""
    f32, i8 = _payload("float32", "handoff"), _payload("int8", "handoff")
    mig = _payload("float32", "migration")
    frames = jax_bufview.pack_frames
    return {
        "missing entry": ("handoff", _drop(f32, "v")),
        "migration missing entry": ("migration", _drop(mig, "last_logits")),
        "empty prompt": ("handoff", {**f32, "prompt": np.zeros((0,), np.int32)}),
        "rank-3 pages": ("handoff", {**f32, "k": f32["k"][0, 0], "v": f32["v"][0, 0]}),
        "k/v mismatch": ("migration", {**mig, "v": mig["v"][:, :1]}),
        "int8 without scales": ("handoff", _drop(_drop(i8, "k_scales"), "v_scales")),
        "scales with float pages": ("migration", {**mig, "k_scales": np.ones((L, 4), np.float32),
                                                  "v_scales": np.ones((L, 4), np.float32)}),
        "scale shape": ("handoff", {**i8, "k_scales": i8["k_scales"][:, :1]}),
        "two frames": ("handoff", frames([f32["prompt"], f32["last_logits"]])),
        "prompt dtype": ("handoff", frames([f32["prompt"].astype(np.int64), f32["last_logits"], f32["k"], f32["v"]])),
        "logits dtype": ("handoff", frames([f32["prompt"], f32["last_logits"].astype(np.float64), f32["k"],
                                            f32["v"]])),
        "page count": ("handoff", frames([f32["prompt"][:5], f32["last_logits"], f32["k"], f32["v"]])),
        "migration tokens dtype": ("migration", frames([mig["prompt"], mig["last_logits"], mig["k"], mig["v"],
                                                        mig["tokens"].astype(np.float32), mig["key_data"],
                                                        np.frombuffer(b"{}", np.uint8)])),
        "meta not json": ("migration", frames([mig["prompt"], mig["last_logits"], mig["k"], mig["v"],
                                               mig["tokens"], mig["key_data"], np.frombuffer(b"{no", np.uint8)])),
        "migration geometry": ("migration", frames([mig["prompt"], mig["last_logits"], mig["k"], mig["v"],
                                                    mig["tokens"][:0], mig["key_data"],
                                                    np.frombuffer(b"{}", np.uint8)])),
    }[case]


@pytest.mark.parametrize("case", ["missing entry", "migration missing entry", "empty prompt", "rank-3 pages",
                                  "k/v mismatch", "int8 without scales", "scales with float pages", "scale shape",
                                  "two frames", "prompt dtype", "logits dtype", "page count",
                                  "migration tokens dtype", "meta not json", "migration geometry"])
def test_malformed_containers_raise_the_jax_messages(case):
    kind, what = _pack_malformed(case)
    if isinstance(what, bytes):
        port_call, jax_call = (lambda f=f: f(what) for f in UNPACK[kind])
    else:
        port_call, jax_call = (lambda f=f: f(what) for f in PACK[kind])
    with pytest.raises(JaxPayloadError) as want:
        jax_call()
    with pytest.raises(PayloadError) as got:
        port_call()
    assert str(got.value) == str(want.value)
