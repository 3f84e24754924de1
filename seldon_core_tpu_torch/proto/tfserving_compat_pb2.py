# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tfserving_compat.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import wrappers_pb2 as google_dot_protobuf_dot_wrappers__pb2
from seldon_core_tpu_torch.proto import tf_compat_pb2 as tf__compat__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x16tfserving_compat.proto\x12\x10seldon.tfserving\x1a\x1egoogle/protobuf/wrappers.proto\x1a\x0ftf_compat.proto\"\x8c\x01\n\tModelSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12.\n\x07version\x18\x02 \x01(\x0b\x32\x1b.google.protobuf.Int64ValueH\x00\x12\x17\n\rversion_label\x18\x04 \x01(\tH\x00\x12\x16\n\x0esignature_name\x18\x03 \x01(\tB\x10\n\x0eversion_choice\"\xe3\x01\n\x0ePredictRequest\x12/\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1b.seldon.tfserving.ModelSpec\x12<\n\x06inputs\x18\x02 \x03(\x0b\x32,.seldon.tfserving.PredictRequest.InputsEntry\x12\x15\n\routput_filter\x18\x03 \x03(\t\x1aK\n\x0bInputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12+\n\x05value\x18\x02 \x01(\x0b\x32\x1c.seldon.tfcompat.TensorProto:\x02\x38\x01\"\xd1\x01\n\x0fPredictResponse\x12/\n\nmodel_spec\x18\x02 \x01(\x0b\x32\x1b.seldon.tfserving.ModelSpec\x12?\n\x07outputs\x18\x01 \x03(\x0b\x32..seldon.tfserving.PredictResponse.OutputsEntry\x1aL\n\x0cOutputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12+\n\x05value\x18\x02 \x01(\x0b\x32\x1c.seldon.tfcompat.TensorProto:\x02\x38\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tfserving_compat_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PREDICTREQUEST_INPUTSENTRY._options = None
  _PREDICTREQUEST_INPUTSENTRY._serialized_options = b'8\001'
  _PREDICTRESPONSE_OUTPUTSENTRY._options = None
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_options = b'8\001'
  _MODELSPEC._serialized_start=94
  _MODELSPEC._serialized_end=234
  _PREDICTREQUEST._serialized_start=237
  _PREDICTREQUEST._serialized_end=464
  _PREDICTREQUEST_INPUTSENTRY._serialized_start=389
  _PREDICTREQUEST_INPUTSENTRY._serialized_end=464
  _PREDICTRESPONSE._serialized_start=467
  _PREDICTRESPONSE._serialized_end=676
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_start=600
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_end=676
# @@protoc_insertion_point(module_scope)
