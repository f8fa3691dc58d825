"""Video encoding of the port: the GOP's coding structure, motion
compensation, and the frame-by-frame encoder. Counterpart of
``coolchic_tpu/video/`` with the same exports."""

from coolchic_tpu_torch.video.codingstructure import (
    CodingStructure,
    Frame,
    lmbda_from_depth,
)
from coolchic_tpu_torch.video.encoder import (
    EncodedFrame,
    FrameEncoderManager,
    TrainingExitCode,
    VideoEncoder,
    is_job_over,
    load_video_encoder,
)
from coolchic_tpu_torch.video.intercoding import bipred, warp

__all__ = [
    "CodingStructure",
    "Frame",
    "lmbda_from_depth",
    "EncodedFrame",
    "FrameEncoderManager",
    "TrainingExitCode",
    "VideoEncoder",
    "is_job_over",
    "load_video_encoder",
    "bipred",
    "warp",
]
