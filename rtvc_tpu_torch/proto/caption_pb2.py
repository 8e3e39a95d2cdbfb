# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: caption.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rcaption.proto\x12\x04rtvc\"\x9a\x01\n\x0e\x43\x61ptionRequest\x12\x0e\n\x06\x66rames\x18\x01 \x01(\x0c\x12\x0e\n\x06window\x18\x02 \x01(\r\x12\x0e\n\x06height\x18\x03 \x01(\r\x12\r\n\x05width\x18\x04 \x01(\r\x12\x11\n\tstream_id\x18\x05 \x01(\t\x12\x11\n\ttimeout_s\x18\x06 \x01(\x02\x12\x0b\n\x03seq\x18\x07 \x01(\x04\x12\x16\n\x0e\x65ncoded_frames\x18\x08 \x03(\x0c\"y\n\x0c\x43\x61ptionReply\x12\x0f\n\x07\x63\x61ption\x18\x01 \x01(\t\x12\x12\n\nlatency_ms\x18\x02 \x01(\x02\x12\x12\n\nsuperseded\x18\x03 \x01(\x08\x12\r\n\x05\x65rror\x18\x04 \x01(\t\x12\x0b\n\x03seq\x18\x05 \x01(\x04\x12\x14\n\x0cstream_error\x18\x06 \x01(\x08\"\x0e\n\x0cStatsRequest\"f\n\nStatsReply\x12*\n\x05stats\x18\x01 \x03(\x0b\x32\x1b.rtvc.StatsReply.StatsEntry\x1a,\n\nStatsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\x32\xb3\x01\n\x0e\x43\x61ptionService\x12\x33\n\x07\x43\x61ption\x12\x14.rtvc.CaptionRequest\x1a\x12.rtvc.CaptionReply\x12=\n\rCaptionStream\x12\x14.rtvc.CaptionRequest\x1a\x12.rtvc.CaptionReply(\x01\x30\x01\x12-\n\x05Stats\x12\x12.rtvc.StatsRequest\x1a\x10.rtvc.StatsReplyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'caption_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _STATSREPLY_STATSENTRY._options = None
  _STATSREPLY_STATSENTRY._serialized_options = b'8\001'
  _CAPTIONREQUEST._serialized_start=24
  _CAPTIONREQUEST._serialized_end=178
  _CAPTIONREPLY._serialized_start=180
  _CAPTIONREPLY._serialized_end=301
  _STATSREQUEST._serialized_start=303
  _STATSREQUEST._serialized_end=317
  _STATSREPLY._serialized_start=319
  _STATSREPLY._serialized_end=421
  _STATSREPLY_STATSENTRY._serialized_start=377
  _STATSREPLY_STATSENTRY._serialized_end=421
  _CAPTIONSERVICE._serialized_start=424
  _CAPTIONSERVICE._serialized_end=603
# @@protoc_insertion_point(module_scope)
