"""Checkpoints without flax, msgpack or orbax: the port's readers and writer
against the JAX package's libraries, and ``model_uri`` serving against
``JaxServer`` / the JAX ``StreamingLM``.

* ``utils/serialization.py``: ``packb`` / ``unpackb`` byte for byte and
  value for value against the ``msgpack`` package; ``to_bytes`` byte for
  byte against ``flax.serialization.to_bytes`` (float32, bfloat16, int8,
  int32, 0-d, complex and numpy-scalar leaves, lists, tuples; arrays
  chunked with ``MAX_CHUNK_SIZE`` patched small on both sides);
  ``from_bytes`` of flax's bytes leaf for leaf, bit for bit, and its
  template errors by the key and path they name.
* ``utils/orbax.py``: what ``orbax.checkpoint.StandardCheckpointer``
  writes here (OCDBT + zarr v2 + zstd) read bit for bit as its own
  ``restore`` reads it: resnet_tiny, vit_tiny and transformer_lm trees in
  float32 and bfloat16, a chunked array, scalars and lists; zarr arrays
  with padded edge chunks and unwritten chunks (tensorstore's zarr
  driver: orbax's chunks divide the array); the OCDBT store's interior
  nodes and out-of-line values against tensorstore's own reader; the
  committed fixture ``tests/data/torch_port_orbax`` (the one
  ``chip_smoke.py`` phase 17c reads on the card) against its digests
  and its JAX logits; the refusals by name.
* ``CudaServer(model_uri=...)`` (a msgpack file, a directory of them, an
  orbax directory) against ``JaxServer`` with the same ``model_uri``:
  resnet_tiny in the bf16 lane (float32 compute), int8w and w8a8,
  vit_tiny, transformer_encoder and transformer_lm.  Tolerances as in
  ``tests/test_torch_port_server.py`` and
  ``tests/test_torch_port_precision_server.py``: float32 and int8w within
  rtol = atol = 1e-4 (summation order only); w8a8, whose two servers each
  calibrate their scales, within 1e-2 relative L2 with the argmax equal
  on at least 90% of the rows.
* ``StreamingLM(model_uri=...)`` with a ``{"uri": ...}`` adapter: greedy
  tokens equal, exactly, to the JAX engine's on the weights and factors
  the JAX package's own loaders read from the same files (float32; the
  JAX ``StreamingLM`` serves bf16 only, so its engine is built from its
  loaders directly).
"""

import json
import os
import struct
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from flax import serialization as flax_serialization

from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models import registry as jax_registry
from seldon_core_tpu.models.generate import load_lm_params as jax_load_lm_params
from seldon_core_tpu.models.jaxserver import JaxServer
from seldon_core_tpu.models.resnet import ResNetTiny as FlaxResNetTiny
from seldon_core_tpu.models.transformer import TransformerEncoder as FlaxTransformerEncoder
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu.models.vit import ViTTiny as FlaxViTTiny
from seldon_core_tpu_torch.models import convert
from seldon_core_tpu_torch.models.cudaserver import CudaServer
from seldon_core_tpu_torch.models.generate import load_lm_params
from seldon_core_tpu_torch.models.paged import StreamingLM
from seldon_core_tpu_torch.ops import lora
from seldon_core_tpu_torch.runtime import MicroserviceError
from seldon_core_tpu_torch.utils import orbax, serialization

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_resnet import random_variables  # noqa: E402
from test_torch_port_w8a8 import w8a8_names  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
NUM_CLASSES = 10
SHAPE = (32, 32, 3)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_bits_equal(got, want, path="."):
    """Leaf for leaf, bit for bit: a port tree (numpy, torch.bfloat16,
    Python numbers) against flax's / orbax's (numpy, ml_dtypes, jax)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            assert_bits_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_bits_equal(g, w, f"{path}/{i}")
    elif want is None or isinstance(want, (bool, int, float, complex, str)):
        assert type(got) is type(want) and got == want, (path, got, want)
    else:
        w = np.asarray(want)
        if isinstance(got, torch.Tensor):
            assert got.dtype == torch.bfloat16 and w.dtype == ml_dtypes.bfloat16, (path, w.dtype)
            g = got.view(torch.int16).numpy()
            w = w.view(np.int16)
        else:
            assert isinstance(got, (np.ndarray, np.generic)) and got.dtype == w.dtype, (path, type(got), w.dtype)
            assert type(got) is type(want) or isinstance(want, jax.Array), (path, type(got), type(want))
            g = np.asarray(got)
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), path


# ---------------------------------------------------------------------------
# msgpack
# ---------------------------------------------------------------------------

MSGPACK_VALUES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    1.5, -0.0, float("inf"), 1e300, "", "a" * 31, "b" * 32, "é" * 200, "d" * 256, "e" * 65536,
    b"", b"x" * 255, b"y" * 256, b"z" * 70000, [], [1] * 15, [1] * 16, [2] * 70000, {},
    {f"k{i}": i for i in range(15)}, {f"k{i}": [i, {"n": None}] for i in range(16)},
    {f"k{i}": i for i in range(70000)},
]
EXT_LENGTHS = [1, 2, 3, 4, 8, 16, 17, 255, 256, 70000]


@pytest.mark.parametrize("value", MSGPACK_VALUES, ids=lambda v: f"{type(v).__name__}-{len(v) if hasattr(v, '__len__') else v}")
def test_msgpack_codec_matches_the_msgpack_package(value):
    data = msgpack.packb(value, use_bin_type=True)
    assert serialization.packb(value) == data
    assert serialization.unpackb(data) == msgpack.unpackb(data, raw=False, strict_map_key=False)


@pytest.mark.parametrize("n", EXT_LENGTHS)
def test_msgpack_ext_and_fixext_match_the_msgpack_package(n):
    data = msgpack.packb(msgpack.ExtType(5, b"q" * n))
    assert serialization.packb(serialization.ExtType(5, b"q" * n)) == data
    assert serialization.unpackb(data) == serialization.ExtType(5, b"q" * n)


def test_msgpack_float32_tuples_strict_types_and_errors():
    f32 = b"\xca" + struct.pack(">f", 1.25)
    assert serialization.unpackb(f32) == msgpack.unpackb(f32) == 1.25
    assert serialization.packb((1, "a")) == msgpack.packb((1, "a"))
    # strict: a tuple or a numpy float64 goes to default, as in msgpack
    seen = []
    serialization.packb((1,), default=lambda o: seen.append(o) or [9], strict_types=True)
    assert seen == [(1,)]
    with pytest.raises(TypeError):
        serialization.packb(np.float64(1.0), strict_types=True)
    with pytest.raises(OverflowError):
        serialization.packb(2**64)
    with pytest.raises(ValueError, match="left after"):
        serialization.unpackb(b"\x01\x02")
    with pytest.raises(ValueError, match="ends inside"):
        serialization.unpackb(b"\xda\x00\x05ab")


# ---------------------------------------------------------------------------
# flax's format
# ---------------------------------------------------------------------------


def _trees():
    rng = np.random.default_rng(0)
    bf16 = np.asarray(rng.normal(size=(5, 3)), ml_dtypes.bfloat16)
    return {
        "f32": {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32), "b": np.zeros(4, np.float32)}},
        "bf16": {"params": {"w": bf16, "b": np.asarray([1.5, -2.0], ml_dtypes.bfloat16)}},
        "int8": {"q": rng.integers(-128, 128, (7, 2)).astype(np.int8), "u": np.arange(300, dtype=np.uint8)},
        "int32": {"ids": rng.integers(-2**31, 2**31 - 1, (4,)).astype(np.int32), "i64": np.arange(3, dtype=np.int64)},
        "0d": {"scalar": np.array(3.0, np.float32), "i": np.array(7, np.int32), "empty": np.zeros((0, 3), np.float32)},
        "complex": {"c64": np.array([1 + 2j, -3j], np.complex64), "c128": np.array([[0.5 + 1j]]),
                    "py": 1.5 - 2.5j},
        "npscalar": {"f32": np.float32(2.5), "f64": np.float64(1.25), "i8": np.int8(-3), "b": np.bool_(True)},
        "mixed": {"lst": [np.ones(2), (np.zeros(1, np.float16), 3)], "n": None, "s": "name", "i": 2**40, "f": 0.5,
                  "t": True, "nested": {"deep": {"x": np.eye(2, dtype=np.float64)}}},
    }


@pytest.mark.parametrize("name", list(_trees()))
def test_to_bytes_is_byte_equal_to_flax(name):
    tree = _trees()[name]
    assert serialization.to_bytes(tree) == flax_serialization.to_bytes(tree)


def test_to_bytes_of_torch_leaves_equals_flax_of_numpy():
    """The port writes torch tensors (bf16 included) as flax writes the
    same values in numpy / ml_dtypes."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    port = {"w": torch.from_numpy(w), "bf": torch.from_numpy(w).to(torch.bfloat16), "t": torch.from_numpy(w).t()}
    ref = {"w": w, "bf": w.astype(ml_dtypes.bfloat16), "t": np.ascontiguousarray(w.T)}
    assert serialization.to_bytes(port) == flax_serialization.to_bytes(ref)


@pytest.mark.parametrize("name", list(_trees()))
def test_from_bytes_reads_flax_bytes_bit_for_bit(name):
    tree = _trees()[name]
    data = flax_serialization.to_bytes(tree)
    got = serialization.from_bytes(tree, data)
    assert_bits_equal(got, flax_serialization.from_bytes(tree, data))
    assert_bits_equal(serialization.msgpack_restore(data), flax_serialization.msgpack_restore(data))
    if name == "bf16":
        assert got["params"]["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(serialization.to_numpy_tree(got)["params"]["w"], tree["params"]["w"].astype(np.float32))


@pytest.mark.parametrize("chunk", [64, 100, 4096])
def test_chunked_arrays_as_flax_writes_them(chunk, monkeypatch):
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", chunk)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.default_rng(2)
    tree = {"big": rng.normal(size=(37, 29)).astype(np.float32),
            "bf": np.asarray(rng.normal(size=(301,)), ml_dtypes.bfloat16),
            "small": np.ones(3, np.float32), "inner": {"i8": rng.integers(-9, 9, (500,)).astype(np.int8)}}
    data = flax_serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    assert serialization.to_bytes(tree) == data
    assert_bits_equal(serialization.from_bytes(tree, data), flax_serialization.from_bytes(tree, data))
    port_tree = {**tree, "bf": torch.from_numpy(tree["bf"].view(np.int16)).view(torch.bfloat16)}
    assert serialization.to_bytes(port_tree) == data


def test_template_mismatches_are_named():
    tree = {"params": {"a": np.ones(2), "b": {"c": np.zeros(1)}}, "lst": [np.ones(1), np.ones(1)]}
    data = flax_serialization.to_bytes(tree)
    missing = {"params": {"a": 0, "b": {"c": 0, "d": 0}}, "lst": [0, 0]}
    with pytest.raises(ValueError, match=r"target dict contains keys \{'d'\}.*path ./params/b") as port_err:
        serialization.from_bytes(missing, data)
    with pytest.raises(ValueError) as flax_err:
        flax_serialization.from_bytes(missing, data)
    assert "'d'" in str(flax_err.value) and "'d'" in str(port_err.value)
    extra = {"params": {"a": 0}, "lst": [0, 0]}  # flax drops the unread 'b'; the port names it
    with pytest.raises(ValueError, match=r"state dict contains keys \{'b'\}.*path ./params"):
        serialization.from_bytes(extra, data)
    with pytest.raises(ValueError, match="size of the list"):
        serialization.from_bytes({"params": {"a": 0, "b": {"c": 0}}, "lst": [0]}, data)
    with pytest.raises(ValueError, match="dtype 'float8_e4m3fn'"):
        serialization.from_bytes({"x": 0}, flax_serialization.to_bytes({"x": np.zeros(2, ml_dtypes.float8_e4m3fn)}))


def test_lm_flax_params_is_the_inverse_of_the_converter():
    fparams = FlaxTransformerLM(dtype=jnp.float32, vocab_size=64, d_model=32, num_layers=2, num_heads=2,
                                max_len=32).init(jax.random.key(3), jnp.zeros((1, 8), jnp.int32))["params"]
    sd = convert.lm_params_from_flax(fparams)
    back = convert.lm_flax_params(sd)
    assert_bits_equal(serialization.to_numpy_tree(back), jax.tree_util.tree_map(np.asarray, dict(fparams)))


# ---------------------------------------------------------------------------
# orbax
# ---------------------------------------------------------------------------


def _orbax_save(path, tree, save_args=None):
    ck = ocp.StandardCheckpointer()
    ck.save(os.path.abspath(path), tree, save_args=save_args)
    ck.wait_until_finished()
    ck.close()
    return str(path)


def _model_tree(model, dtype):
    if model == "resnet_tiny":
        tree = random_variables(FlaxResNetTiny(num_classes=NUM_CLASSES), SHAPE, seed=11)
    elif model == "vit_tiny":
        tree = FlaxViTTiny(num_classes=NUM_CLASSES, dtype=jnp.float32).init(
            jax.random.key(12), jnp.zeros((1, *SHAPE), jnp.float32))
    else:
        tree = FlaxTransformerLM(dtype=jnp.float32, vocab_size=64, d_model=32, num_layers=2, num_heads=2,
                                 max_len=32).init(jax.random.key(13), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), dict(tree))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["resnet_tiny", "vit_tiny", "transformer_lm"])
def test_orbax_reader_equals_orbax_restore(model, dtype, tmp_path):
    path = _orbax_save(tmp_path / "ckpt", _model_tree(model, jnp.dtype(dtype)))
    assert orbax.is_checkpoint(path)
    got = orbax.restore(path)
    assert_bits_equal(got, ocp.StandardCheckpointer().restore(path))
    leaf = jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert (leaf.dtype == torch.bfloat16) if dtype == "bfloat16" else (leaf.dtype == np.float32)


def test_orbax_reader_without_ocdbt(tmp_path):
    """``use_ocdbt=False``: each array a zarr directory of plain files."""
    tree = {"params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                       "b": jnp.asarray(np.linspace(-2, 2, 5), jnp.bfloat16)}}
    ck = ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False))
    ck.save(str(tmp_path / "ckpt"), ocp.args.StandardSave(tree))
    ck.close()
    path = str(tmp_path / "ckpt")
    assert not os.path.exists(os.path.join(path, "manifest.ocdbt"))
    assert_bits_equal(orbax.restore(path), ocp.StandardCheckpointer().restore(path))


def test_orbax_reader_chunks_scalars_and_lists(tmp_path):
    rng = np.random.default_rng(4)
    tree = {"params": {"big": rng.normal(size=(37, 29)).astype(np.float32),
                       "bf": jnp.asarray(rng.normal(size=(50, 40)), jnp.bfloat16),
                       "i8": rng.integers(-100, 100, (300,)).astype(np.int8),
                       "lst": [np.arange(5, dtype=np.int32), np.float32(2.5)], "f": 1.5, "n": 3},
            "stats": {"m": jnp.asarray(rng.normal(size=(64,)), jnp.float32)}}
    save_args = jax.tree_util.tree_map(lambda _: ocp.SaveArgs(), tree)
    save_args["params"]["big"] = ocp.SaveArgs(chunk_byte_size=1024)
    save_args["params"]["bf"] = ocp.SaveArgs(chunk_byte_size=1500)
    path = _orbax_save(tmp_path / "ckpt", tree, save_args)
    chunks = json.loads(orbax.OcdbtStore(path).get("params.big/.zarray"))["chunks"]
    assert chunks[0] < 37, chunks  # several chunks
    assert_bits_equal(orbax.restore(path), ocp.StandardCheckpointer().restore(path))


@pytest.mark.parametrize("dtype", ["<f4", "bfloat16", "|i1"])
def test_zarr_padded_edge_chunks_and_missing_chunks(dtype, tmp_path):
    """orbax picks chunks that divide the array; zarr lets the edge chunks
    run over, padded, and leaves unwritten chunks to the fill value:
    written here with tensorstore's zarr driver."""
    import tensorstore as ts

    rng = np.random.default_rng(5)
    full = rng.normal(size=(37, 29)).astype(np.float32) * 50
    arr = full.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else full.astype(np.dtype(dtype))
    store = ts.open({"driver": "zarr", "kvstore": f"file://{tmp_path}/arr",
                     "metadata": {"dtype": dtype, "shape": [37, 29], "chunks": [8, 10],
                                  "compressor": {"id": "zstd", "level": 1}, "fill_value": 7}},
                    create=True).result()
    store[:30].write(arr[:30]).result()  # rows 32..36 of the grid stay unwritten
    want = store.read().result()
    got = orbax.read_zarr(orbax.DirectoryStore(str(tmp_path)), "arr")
    assert_bits_equal(got, want)
    assert float(np.asarray(want[36, 0], np.float32)) == 7.0


def test_ocdbt_interior_nodes_and_out_of_line_values_equal_tensorstore(tmp_path):
    import tensorstore as ts

    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}",
            "config": {"compression": {"id": "zstd", "level": 5}, "max_inline_value_bytes": 8,
                       "max_decoded_node_bytes": 256}}
    kv = ts.KvStore.open(spec).result()
    for i in range(60):
        kv.write(f"key{i:03d}/x", bytes([i]) * (i % 20)).result()
    store = orbax.OcdbtStore(str(tmp_path))
    keys = kv.list().result()
    assert sorted(store.values) == sorted(keys) and len(keys) == 60
    assert any(isinstance(v, tuple) for v in store.values.values())  # some values out of line
    for k in keys:
        assert store.get(k.decode()) == kv.read(k).result().value


FIXTURE = os.path.join(os.path.dirname(__file__), "data", "torch_port_orbax")


def test_committed_orbax_fixture_matches_orbax_and_the_jax_server():
    """The fixture phase 17c reads on the card: every leaf as orbax
    restores it (``digest.json``), and the port's float32 server on it
    within rtol = atol = 1e-4 of the JAX server's logits (``logits.npy``)."""
    import hashlib

    path = os.path.join(FIXTURE, "resnet_tiny")
    with open(os.path.join(FIXTURE, "digest.json")) as f:
        digest = json.load(f)
    got = orbax.restore(path)
    want = ocp.StandardCheckpointer().restore(path)
    assert_bits_equal(got, want)
    flat = {"/".join(str(p.key) for p in k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(want)}
    assert sorted(flat) == sorted(digest)
    for key, arr in flat.items():
        assert digest[key] == {"dtype": str(arr.dtype), "shape": list(arr.shape),
                               "sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()}, key
    cs = CudaServer(device="cpu", model="resnet_tiny", num_classes=NUM_CLASSES, dtype="float32", normalize=True,
                    max_batch_size=4, warmup=False, model_uri=path)
    cs.load()
    try:
        logits = cs.predict(np.load(os.path.join(FIXTURE, "images.npy")), [])
    finally:
        cs.unload()
    np.testing.assert_allclose(logits, np.load(os.path.join(FIXTURE, "logits.npy")), **TOL)


def test_orbax_refusals_are_named(tmp_path, monkeypatch):
    path = _orbax_save(tmp_path / "ckpt", {"w": np.ones(3, np.float32)})
    meta = json.loads(open(os.path.join(path, "_METADATA")).read())
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({**meta, "use_zarr3": True}, f)
    with pytest.raises(orbax.CheckpointError, match="use_zarr3"):
        orbax.restore(path)
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump(meta, f)
    manifest = os.path.join(path, "manifest.ocdbt")
    raw = bytearray(open(manifest, "rb").read())
    raw[20] ^= 0xFF
    open(manifest, "wb").write(bytes(raw))
    with pytest.raises(orbax.CheckpointError, match="CRC-32C"):
        orbax.restore(path)
    raw[20] ^= 0xFF
    open(manifest, "wb").write(bytes(raw))
    monkeypatch.setattr(orbax, "_zstd_lib", None)
    monkeypatch.setattr(orbax.ctypes, "CDLL", lambda name: (_ for _ in ()).throw(OSError(name)))
    with pytest.raises(orbax.CheckpointError, match="libzstd"):
        orbax.restore(path)


# ---------------------------------------------------------------------------
# CudaServer(model_uri=...) against JaxServer(model_uri=...)
# ---------------------------------------------------------------------------

TOKEN_KW = {"vocab_size": 64, "d_model": 32, "num_layers": 2, "num_heads": 2, "max_len": 32}
SERVED = {
    "resnet_tiny-bf16": dict(model="resnet_tiny", normalize=True),
    "resnet_tiny-int8w": dict(model="resnet_tiny", normalize=True, precision="int8w"),
    "resnet_tiny-w8a8": dict(model="resnet_tiny", normalize=True, precision="w8a8", seed=3),
    "vit_tiny": dict(model="vit_tiny", normalize=True),
    "transformer_encoder": dict(model="transformer_encoder", num_classes=3, input_shape=(24,),
                                warmup_dtypes=("int32",), model_kwargs=TOKEN_KW),
    "transformer_lm": dict(model="transformer_lm", input_shape=(24,), warmup_dtypes=("int32",),
                           model_kwargs=TOKEN_KW),
}


def _served_variables(case):
    if case.startswith("resnet_tiny"):
        variables = random_variables(FlaxResNetTiny(num_classes=NUM_CLASSES), SHAPE, seed=21)
        return w8a8_names(variables) if case.endswith("w8a8") else variables
    if case == "vit_tiny":
        return FlaxViTTiny(num_classes=NUM_CLASSES, dtype=jnp.float32).init(
            jax.random.key(5), jnp.zeros((1, *SHAPE), jnp.float32))
    if case == "transformer_lm":
        return FlaxTransformerLM(dtype=jnp.float32, **TOKEN_KW).init(jax.random.key(7), jnp.zeros((1, 24), jnp.int32))
    return FlaxTransformerEncoder(num_classes=3, dtype=jnp.float32, **TOKEN_KW).init(
        jax.random.key(6), jnp.zeros((1, 24), jnp.int32))


def _write(fmt, variables, tmp_path):
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    if fmt == "orbax":
        return _orbax_save(tmp_path / "orbax", variables)
    data = flax_serialization.to_bytes(variables)
    if fmt == "file":
        (tmp_path / "model.msgpack").write_bytes(data)
        return f"file://{tmp_path / 'model.msgpack'}"
    (tmp_path / "a.msgpack").write_bytes(data)
    (tmp_path / "z.bin").write_bytes(b"not the first name")  # the first sorted name is served
    return str(tmp_path)


@pytest.mark.parametrize("fmt", ["file", "directory", "orbax"])
@pytest.mark.parametrize("case", list(SERVED))
def test_cudaserver_model_uri_matches_jaxserver(case, fmt, tmp_path):
    uri = _write(fmt, _served_variables(case), tmp_path)
    common = {**dict(num_classes=NUM_CLASSES, dtype="float32", max_batch_size=4, warmup=False, model_uri=uri),
              **SERVED[case]}
    js, cs = JaxServer(**common), CudaServer(device="cpu", **common)
    js.load()
    cs.load()
    try:
        if case.startswith("transformer"):
            x = np.random.default_rng(7).integers(0, 64, (3, 24)).astype(np.int32)
        else:
            x = np.random.default_rng(8).integers(0, 256, (6, *SHAPE)).astype(np.uint8)
        want, got = np.asarray(js.predict(x, [])), np.asarray(cs.predict(x, []))
        assert got.shape == want.shape and np.isfinite(got).all()
        if case.endswith("w8a8"):
            assert cs.act_scales_calibrated == js.act_scales_calibrated == 11
            assert _rel_l2(got, want) <= 1e-2 and (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
        else:
            np.testing.assert_allclose(got, want, **TOL)
        times = cs.health_status()["checkpoint_times"]
        assert set(times) == {"download_s", "decode_s", "convert_s", "pin_s"}
    finally:
        js.unload()
        cs.unload()


def test_cudaserver_model_uri_refusals(tmp_path):
    with pytest.raises(MicroserviceError, match="not both") as err:
        CudaServer(device="cpu", model="resnet_tiny", model_uri=str(tmp_path), variables={})
    assert err.value.reason == "BAD_PARAMETER"
    with pytest.raises(MicroserviceError, match="no .msgpack checkpoint") as err:
        CudaServer(device="cpu", model="resnet_tiny", model_uri=str(tmp_path), warmup=False).load()
    assert err.value.reason == "BAD_CHECKPOINT"
    (tmp_path / "w.msgpack").write_bytes(b"\xc1")
    with pytest.raises(MicroserviceError, match="unused type byte") as err:
        CudaServer(device="cpu", model="resnet_tiny", model_uri=str(tmp_path / "w.msgpack"), warmup=False).load()
    assert err.value.reason == "BAD_CHECKPOINT"
    (tmp_path / "w.msgpack").write_bytes(flax_serialization.to_bytes({"params": {"head": {"bias": np.ones(2)}}}))
    with pytest.raises(ValueError, match="missing"):
        CudaServer(device="cpu", model="resnet_tiny", model_uri=str(tmp_path / "w.msgpack"), warmup=False).load()


# ---------------------------------------------------------------------------
# StreamingLM(model_uri=...) and {"uri": ...} adapters against the JAX engine
# ---------------------------------------------------------------------------

LM_CFG = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=2, max_len=256)
LM_ENGINE = dict(page_size=8, max_slots=4, steps_per_call=4)
RANK = 2
MAX_NEW = 8


def _lm_prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(0, LM_CFG["vocab_size"], size=(n,)).astype(np.int32) for n in (14, 7, 25, 9)]


@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    params = FlaxTransformerLM(dtype=jnp.float32, **LM_CFG).init(jax.random.key(17), jnp.zeros((1, 8), jnp.int32))
    (d / "lm.msgpack").write_bytes(flax_serialization.to_bytes(jax.tree_util.tree_map(np.asarray, params["params"])))
    factors = lora.make_lora_params(23, num_layers=LM_CFG["num_layers"], d_model=LM_CFG["d_model"], rank=RANK,
                                    alpha=4.0)
    (d / "a.msgpack").write_bytes(flax_serialization.to_bytes(factors))
    return f"file://{d / 'lm.msgpack'}", f"file://{d / 'a.msgpack'}"


def test_load_lm_params_overlays_the_checkpoint_as_jax(lm_files):
    lm_uri, _ = lm_files
    want = convert.lm_params_from_flax(jax.tree_util.tree_map(np.asarray, jax_load_lm_params(lm_uri, LM_CFG, 0)))
    got = load_lm_params(lm_uri, LM_CFG, seed=5)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())


def test_streaminglm_model_uri_and_uri_adapter_match_the_jax_engine(lm_files, monkeypatch):
    lm_uri, adapter_uri = lm_files
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", "force")
    monkeypatch.setenv("SELDON_TPU_CHUNK_IMPL", "pool")
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL_IMPL", "stream")
    # the JAX side reads both files with its own loaders
    jax_lm = jax_paged.StreamingLM(adapters={"a": {"uri": adapter_uri}}, lora_rank=RANK, max_adapters=1,
                                   **LM_CFG, **LM_ENGINE)
    factors = jax_lm._adapter_loader("a", {"uri": adapter_uri})()
    reg = jax_registry.WeightRegistry(budget_bytes=0)
    reg.register("a", lambda: factors, bytes_hint=lora.adapter_bytes(factors))
    eng = jax_paged.PagedEngine(jax_load_lm_params(lm_uri, LM_CFG, 0), dtype=jnp.float32, prefix_cache=False,
                                max_adapters=1, lora_rank=RANK, weight_registry=reg, **LM_CFG, **LM_ENGINE)
    want = {}
    for adapter in (None, "a"):
        streams = [eng.submit(p, max_new_tokens=MAX_NEW, adapter=adapter) for p in _lm_prompts()]
        eng.run()
        want[adapter] = [s.result.tolist() for s in streams]
    eng.close()
    assert want[None] != want["a"]

    lm = StreamingLM(device="cpu", dtype="float32", model_uri=lm_uri, adapters={"a": {"uri": adapter_uri}},
                     max_adapters=1, lora_rank=RANK, max_new_tokens=MAX_NEW, prefix_cache=False, **LM_CFG,
                     **LM_ENGINE)
    lm.load()
    try:
        for adapter in (None, "a"):
            tags = {"adapter": adapter} if adapter else {}
            got = [lm.predict(p[None], [], {"tags": tags})[0].tolist() for p in _lm_prompts()]
            assert got == want[adapter], adapter
    finally:
        lm.unload()
