# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: sparktts.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0esparktts.proto\x12\x08sparktts\"\xbc\x01\n\x10SynthesisRequest\x12\x0c\n\x04text\x18\x01 \x01(\t\x12\x12\n\nprompt_wav\x18\x02 \x01(\x0c\x12\x13\n\x0bprompt_text\x18\x03 \x01(\t\x12\x0e\n\x06gender\x18\x04 \x01(\t\x12\r\n\x05pitch\x18\x05 \x01(\t\x12\r\n\x05speed\x18\x06 \x01(\t\x12\x16\n\x0emax_new_tokens\x18\x07 \x01(\x05\x12\x10\n\x08longform\x18\x08 \x01(\x08\x12\x19\n\x11max_segment_chars\x18\t \x01(\x05\"L\n\nAudioChunk\x12\x0b\n\x03pcm\x18\x01 \x01(\x0c\x12\x13\n\x0bsample_rate\x18\x02 \x01(\x05\x12\r\n\x05\x66inal\x18\x03 \x01(\x08\x12\r\n\x05\x65rror\x18\x04 \x01(\t2\x92\x01\n\x08SparkTTS\x12>\n\nSynthesize\x12\x1a.sparktts.SynthesisRequest\x1a\x14.sparktts.AudioChunk\x12\x46\n\x10SynthesizeStream\x12\x1a.sparktts.SynthesisRequest\x1a\x14.sparktts.AudioChunk0\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'sparktts_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SYNTHESISREQUEST._serialized_start=29
  _SYNTHESISREQUEST._serialized_end=217
  _AUDIOCHUNK._serialized_start=219
  _AUDIOCHUNK._serialized_end=295
  _SPARKTTS._serialized_start=298
  _SPARKTTS._serialized_end=444
# @@protoc_insertion_point(module_scope)
