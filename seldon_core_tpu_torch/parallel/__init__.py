"""Device-mesh parallelism: mesh construction, shardings, sharded training.

The port's counterpart of ``seldon_core_tpu/parallel``.  Design note:

**What a mesh is.**  The JAX package is single-controller: one process
and one engine object drive every device of a ``jax.sharding.Mesh``, and
GSPMD inserts the collectives.  The port keeps the one controller and
makes the rest explicit.  A :class:`Mesh` is ``axis_names`` plus a numpy
object array of ``torch.device`` in the grid's shape; a sharded tensor
is one tensor a position (:class:`ShardedTensor`), and a collective is a
torch operation in the one process (:func:`all_gather`,
:func:`all_reduce`, :func:`ppermute`).  ``create_mesh(axes)`` defaults to
every CUDA device of the host and raises without one: a mesh never falls
back to the CPU.  An explicit ``devices`` list may repeat a device: a
``{"data": 2, "model": 2}`` mesh of four ``cuda:0`` positions runs the
sharded programs on one card, as the JAX package's tests run theirs on
eight forced host devices, and the port's CPU tests hold a mesh of CPU
positions against the JAX package's.  ``torch.distributed`` is used only
where the JAX package crosses processes (:mod:`.multihost`): NCCL refuses
two ranks on one GPU, so one rank a device could not run any mesh on a
one-card host.

**The knobs.**  ``resolve_tp`` / ``resolve_dp`` / ``resolve_mesh`` /
``tp_mesh`` / ``mesh_from_axes`` keep JAX's precedence (mesh >
``mesh_axes`` > ``tp=`` / ``dp=`` > ``SELDON_TPU_TP`` / ``SELDON_TPU_DP``),
drop size-1 axes, build data-major meshes and shrink the data axis first
with JAX's WARN (``strict=True`` raises).  They count **distinct** CUDA
devices: ``SELDON_TPU_TP=2`` on a one-card host degrades to one device
with the WARN, as JAX does on a one-chip host; the engines report the
degree they really run.

**Where shards live.**  ``infer_param_specs`` returns JAX's spec for
every leaf; ``shard_params`` puts one tensor a position along it
(replicated leaves once per distinct device).  JAX's spec for the fused
``qkv`` kernel (d, 3d) splits its 3d output columns in halves, so at
tp=2 position 0 holds all of q and half of k, not whole heads.  GSPMD
hides that; the port's tensor-parallel programs (:mod:`.tp`) all-gather
every column-parallel output before heads are split, and shard the
attention itself by heads over the pool's head shards.  Row-parallel
products end in an all-reduce, so float32 logits can differ from the
one-device engine's by summation order; greedy tokens do not
(``ROADMAP.md`` C28).

**The paged engine under a mesh** does what the JAX engine does: the
gather lane and the ring chunk, never K4; an int8 KV pool stays native
with JAX's WARN; lanes split over ``data`` (JAX's WARN when ``max_slots``
does not divide); the pool created already sharded, pages over ``data``
unless ``SELDON_TPU_SEQ_SHARD=0`` and heads over ``model``, its page
count rounded up to a multiple of dp.  The pool keeps the port's split
layout (flat and split differ only by the TPU's tile padding).

**A second forward, and what it costs.**  The mesh programs are a
forward of their own: :class:`.tp.MeshPagedLM` runs the LM's layers once
(``_run``: embeddings, LayerNorm, the dense layers with their int8w,
w8a8 and LoRA variants, attention, the MLP, the head) for the paged
gather lane, the ring chunk and the ``Generator``'s cached forward, each
of which passes only its attention.  It sits beside the one-device
``PagedTransformerLM`` and ``TransformerLM``, whose blocks hold one
tensor a weight and call the K3 / K4 kernels.  The alternative, column-
and row-parallel dense modules holding ``ShardedTensor`` weights and
plugged into the existing blocks, would make every activation of those
blocks a set of per-position tensors, on the one-device path that every
kernel-bearing phase runs; on one card a mesh gains nothing (C29), so
this slice keeps the two forwards apart.  The cost: a change to a block
(LoRA, w8a8, the MLP, LayerNorm) is made in both, and only the CPU
parity tests (``tests/test_torch_port_paged_mesh.py``, the mesh cases
of ``test_torch_port_generate.py``) catch a drift between them.  The
engine meets the mesh in four places: ``write_kv`` (a sharded pool's
writes), ``_chunk_ring`` (the ring chunk's context and buffers),
``_materialized`` and ``weight_bytes``.  Folding the mesh into the
blocks is ``ROADMAP.md`` A12.1, for a host with several cards.

**What one card shows.**  Logical positions on ``cuda:0`` prove the
sharded programs correct on the card; they show no memory or speed gain,
and none is claimed (``ROADMAP.md`` C29).  A host with several cards gets
distinct ``cuda:i`` positions joined by peer copies; that is unverified.
"""

from seldon_core_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    create_mesh,
    mesh_from_axes,
    mesh_shape,
    resolve_dp,
    resolve_mesh,
    resolve_tp,
    single_device_mesh,
    tp_mesh,
)
from seldon_core_tpu_torch.parallel.sharding import (  # noqa: F401
    P,
    ShardedTensor,
    all_gather,
    all_reduce,
    data_sharded,
    infer_param_specs,
    ppermute,
    replicated,
    shard_params,
)
from seldon_core_tpu_torch.parallel.train import ShardedTrainer, cross_entropy_loss  # noqa: F401
