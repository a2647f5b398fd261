# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: component_broadcast.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x19\x63omponent_broadcast.proto\x12\x14\x65lodin_tpu.broadcast\"\x9a\x01\n\x0f\x43omponentSample\x12\x11\n\tsource_id\x18\x01 \x01(\t\x12\x11\n\tcomponent\x18\x02 \x01(\t\x12\x0e\n\x06rename\x18\x03 \x01(\t\x12\x14\n\x0ctimestamp_us\x18\x04 \x01(\x03\x12\x0c\n\x04prim\x18\x05 \x01(\t\x12\r\n\x05shape\x18\x06 \x03(\r\x12\x0c\n\x04\x64\x61ta\x18\x07 \x01(\x0c\x12\x10\n\x08sequence\x18\x08 \x01(\x04\"Y\n\tHeartbeat\x12\x11\n\tsource_id\x18\x01 \x01(\t\x12\x12\n\ncomponents\x18\x02 \x03(\t\x12\x0f\n\x07rate_hz\x18\x03 \x01(\x02\x12\x14\n\x0ctimestamp_us\x18\x04 \x01(\x03\"\x81\x01\n\x08\x44\x61tagram\x12\x37\n\x06sample\x18\x01 \x01(\x0b\x32%.elodin_tpu.broadcast.ComponentSampleH\x00\x12\x34\n\theartbeat\x18\x02 \x01(\x0b\x32\x1f.elodin_tpu.broadcast.HeartbeatH\x00\x42\x06\n\x04kindb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'component_broadcast_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _COMPONENTSAMPLE._serialized_start=52
  _COMPONENTSAMPLE._serialized_end=206
  _HEARTBEAT._serialized_start=208
  _HEARTBEAT._serialized_end=297
  _DATAGRAM._serialized_start=300
  _DATAGRAM._serialized_end=429
# @@protoc_insertion_point(module_scope)
