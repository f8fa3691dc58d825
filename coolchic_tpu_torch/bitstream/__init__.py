"""The ``.cool`` bitstream of the port: writer, decoder and headers.

Counterpart of ``coolchic_tpu/bitstream/`` with the same file names and the
same exports.
"""

from coolchic_tpu_torch.bitstream.decode import (
    decode_bitstream,
    decode_bitstreams,
    decode_video_bitstream,
)
from coolchic_tpu_torch.bitstream.encode import (
    encode_frame_bitstream,
    encode_image_bitstream,
)
from coolchic_tpu_torch.bitstream.header import (
    FrameHeader,
    GopHeader,
    read_frame_header,
    read_gop_header,
    write_frame_header,
    write_gop_header,
)

__all__ = [
    "decode_bitstream",
    "decode_bitstreams",
    "decode_video_bitstream",
    "encode_frame_bitstream",
    "encode_image_bitstream",
    "FrameHeader",
    "GopHeader",
    "read_frame_header",
    "read_gop_header",
    "write_frame_header",
    "write_gop_header",
]
