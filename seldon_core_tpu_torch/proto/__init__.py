"""Generated protobuf bindings for the seldon-core-tpu wire contract.

``seldon.proto``, ``tf_compat.proto`` and their ``*_pb2`` modules are
copies of the JAX package's, byte for byte except the one import line
that names this package.  The serialized descriptors are identical, so
a process that imports both packages registers ``seldon.proto`` once in
protobuf's descriptor pool (an identical second registration is
accepted).  Do not regenerate or rename them on their own.
"""

from seldon_core_tpu_torch.proto import seldon_pb2 as pb  # noqa: F401

SeldonMessage = pb.SeldonMessage
SeldonMessageList = pb.SeldonMessageList
DefaultData = pb.DefaultData
Tensor = pb.Tensor
RawTensor = pb.RawTensor
Meta = pb.Meta
Metric = pb.Metric
Status = pb.Status
Feedback = pb.Feedback
RequestResponse = pb.RequestResponse
