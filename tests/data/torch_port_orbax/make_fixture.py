"""Writes the orbax fixture the port's checkpoint reader is held to.

    JAX_PLATFORMS=cpu python tests/data/torch_port_orbax/make_fixture.py

With the JAX package (flax, orbax, tensorstore installed): a
``resnet_tiny`` (10 classes, 32x32x3) variables tree drawn from numpy
with seed 7, each float32 rounded toward zero to 4 significant bits (its
low 20 bits zero, so zstd packs the files small), and saved by
``orbax.checkpoint.StandardCheckpointer`` into ``resnet_tiny/``; four seeded uint8 images (``images.npy``); the float32
logits ``JaxServer`` serves for them from that checkpoint
(``model_uri``, ``normalize=true``; ``logits.npy``); and ``digest.json``,
each leaf as ``orbax.checkpoint`` restores it: its dtype, shape and the
SHA-256 of its bytes.  ``chip_smoke.py`` phase 17c and
``tests/test_torch_port_checkpoint.py`` read these files.
"""

import hashlib
import json
import os
import shutil
import sys

import jax
import numpy as np
import orbax.checkpoint as ocp

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))  # tests/, for random_variables
sys.path.insert(0, os.path.join(HERE, "..", "..", ".."))  # the repo root

from seldon_core_tpu.models.jaxserver import JaxServer  # noqa: E402
from seldon_core_tpu.models.resnet import ResNetTiny  # noqa: E402
from test_torch_port_resnet import random_variables  # noqa: E402

NUM_CLASSES, SHAPE, SEED = 10, (32, 32, 3), 7


def leaf_digests(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        arr = np.asarray(leaf)
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = {"dtype": str(arr.dtype), "shape": list(arr.shape),
                    "sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()}
    return out


def main():
    ckpt = os.path.join(HERE, "resnet_tiny")
    shutil.rmtree(ckpt, ignore_errors=True)
    variables = jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFF00000)).view(np.float32),
        random_variables(ResNetTiny(num_classes=NUM_CLASSES), SHAPE, SEED))
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(ckpt, variables)
    checkpointer.wait_until_finished()
    checkpointer.close()
    images = np.random.default_rng(SEED).integers(0, 256, (4, *SHAPE)).astype(np.uint8)
    server = JaxServer(model="resnet_tiny", num_classes=NUM_CLASSES, dtype="float32", normalize=True,
                       max_batch_size=4, warmup=False, model_uri=ckpt)
    server.load()
    logits = np.asarray(server.predict(images, []), np.float32)
    server.unload()
    np.save(os.path.join(HERE, "images.npy"), images)
    np.save(os.path.join(HERE, "logits.npy"), logits)
    with open(os.path.join(HERE, "digest.json"), "w") as f:
        json.dump(leaf_digests(ocp.StandardCheckpointer().restore(ckpt)), f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
