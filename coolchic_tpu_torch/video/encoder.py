"""Video encoder: one overfitted Cool-chic decoder per frame, in coding order.

Counterpart of ``coolchic_tpu/video/encoder.py``. Frames are encoded one
after another, each through the image pipeline
(``train/encode.py::encode_frame_with_quant_info``) with a rate weight
scaled by its GOP depth. A P / B frame synthesizes 6 / 9 channels (residue,
flows, gains) and is trained with the motion-compensated forward against its
reference frames, which ride its target as further channels
(``train/step.py::split_target``).

Each reference is the frame exactly as a decoder reconstructs it: the
frame's stream is written and decoded back through the integer pipeline
(``_integer_reconstruct``), so that the written stream is free of drift.
After every frame the whole state can be pickled (numpy arrays only, so a
machine without a GPU loads it); with a time budget ``encode`` returns
``REQUEUE`` and a later call resumes from ``load_video_encoder``.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from dataclasses import dataclass
from enum import Enum
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from coolchic_tpu_torch.bitstream.decode import _decode_frame_raw12
from coolchic_tpu_torch.bitstream.encode import encode_frame_bitstream
from coolchic_tpu_torch.bitstream.header import GopHeader, write_gop_header
from coolchic_tpu_torch.bitstream.inter import HALF, PREC, process_inter_int
from coolchic_tpu_torch.io.image import convert_420_to_444, load_frame_data_from_file
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import frame_forward
from coolchic_tpu_torch.params import to_numpy_pytree
from coolchic_tpu_torch.train.encode import EncodeStats, encode_frame_with_quant_info
from coolchic_tpu_torch.train.presets import Preset
from coolchic_tpu_torch.train.step import split_target
from coolchic_tpu_torch.utils.trace import span
from coolchic_tpu_torch.utils.types import resolve_device
from coolchic_tpu_torch.video.codingstructure import CodingStructure, Frame, lmbda_from_depth

# Significance block size of the frame streams written to reconstruct the
# references (the writer's default); ``to_bitstream`` reuses them at this size.
RECONSTRUCT_HLS_SIG_BLKSIZE = 16
SEED_STRIDE = 7919  # a frame's seed: seed + SEED_STRIDE * coding order + loop


class TrainingExitCode(Enum):
    """Process exit codes: 42 asks a time-sliced cluster job to requeue."""

    END = 0
    REQUEUE = 42


def is_job_over(start_time: float, max_duration_job_min: int = 45) -> bool:
    if max_duration_job_min < 0:
        return False
    return (time.time() - start_time) / 60 >= max_duration_job_min


@dataclass
class FrameEncoderManager:
    """Per-frame training bookkeeping."""

    lmbda: float
    loop_counter: int = 0
    best_loss: float = float("inf")
    iterations_counter: int = 0
    total_training_time_sec: float = 0.0


@dataclass
class EncodedFrame:
    params: Dict[str, Any]  # numpy arrays, the JAX package's layout
    infos: Optional[Dict[str, Any]]  # per-module ModuleQuantInfo (None: never quantized)
    manager: FrameEncoderManager
    psnr_db: float
    rate_latent_bpp: float
    # The frame as a decoder reconstructs it, [3, H, W] float32 (4:2:0 chroma
    # repeated 2x2): the reference of the frames that depend on it.
    decoded: Optional[np.ndarray] = None
    # This frame's stream, written at RECONSTRUCT_HLS_SIG_BLKSIZE to
    # reconstruct it (None without NN quantization).
    frame_bytes: Optional[bytes] = None
    stats: Optional[EncodeStats] = None  # work and stage seconds of the kept loop


def _writer_choices(infos) -> Tuple[Dict, Dict]:
    """The q-steps and exp-Golomb orders per module, as the writer takes them."""
    q_step = {m: {"weight": float(i.q_step_w), "bias": float(i.q_step_b)} for m, i in infos.items()}
    expgol = {m: {"weight": int(i.expgol_w), "bias": int(i.expgol_b)} for m, i in infos.items()}
    return q_step, expgol


class VideoEncoder:
    """Encode a GOP of frames, one overfitted Cool-chic decoder each, on
    ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(
        self,
        coding_structure: CodingStructure,
        cfg: CoolChicConfig,
        preset: Preset,
        lmbda: float = 1e-3,
        n_loops: int = 1,
        device: str | torch.device = "cuda",
    ):
        self.coding_structure = coding_structure
        self.cfg = cfg
        self.preset = preset
        self.lmbda = lmbda
        self.n_loops = n_loops
        self.device = device
        self.all_frame_encoders: Dict[str, EncodedFrame] = {}
        self.bitdepth = 8
        self.frame_data_type = "rgb"

    def _load_frame(self, input_path: str, display_order: int) -> np.ndarray:
        fd = load_frame_data_from_file(input_path, display_order)
        self.bitdepth = fd.bitdepth
        self.frame_data_type = fd.frame_data_type
        if fd.frame_data_type == "yuv420":
            return convert_420_to_444(fd.data)
        return fd.data

    def encode(
        self,
        input_path: str,
        seed: int = 0,
        job_duration_min: int = -1,
        workdir: Optional[Path] = None,
        verbose: bool = True,
    ) -> TrainingExitCode:
        """Encode every frame not yet encoded, in coding order. Returns
        REQUEUE when the time budget runs out before the GOP's end (resume
        by calling again, after ``load_video_encoder``)."""
        device = resolve_device(self.device)
        start_time = time.time()
        for idx_coding_order in range(self.coding_structure.get_number_of_frames()):
            if str(idx_coding_order) in self.all_frame_encoders:
                continue  # encoded by an earlier call
            frame = self.coding_structure.get_frame_from_coding_order(idx_coding_order)
            cfg_f = self.frame_cfg(frame.frame_type)
            target = np.concatenate(
                [self._load_frame(input_path, frame.display_order), *self._refs_for(frame)])
            target = torch.tensor(target, device=device)
            lmbda = lmbda_from_depth(frame.depth, self.lmbda)
            manager = FrameEncoderManager(lmbda=lmbda)
            frame_start_time = time.time()

            best = None
            for loop in range(self.n_loops):
                result, infos = encode_frame_with_quant_info(
                    target, lmbda, cfg_f, self.preset,
                    seed=seed + SEED_STRIDE * idx_coding_order + loop)
                manager.loop_counter += 1
                if best is None or result.loss < manager.best_loss:
                    manager.best_loss = result.loss
                    best = (result, infos)
            result, infos = best
            manager.total_training_time_sec = time.time() - frame_start_time

            frame_bytes = None
            if infos is not None:
                decoded, frame_bytes = self._integer_reconstruct(
                    result.params, infos, frame, cfg_f, result.stats)
            else:  # no stream without NN quantization: the float eval forward
                _, refs = split_target(cfg_f, target)
                with torch.no_grad():
                    decoded = frame_forward(result.params, cfg_f, training=False,
                                            bitdepth=self.bitdepth, refs=refs)[0]
                decoded = decoded.cpu().numpy()

            self.all_frame_encoders[str(idx_coding_order)] = EncodedFrame(
                params=to_numpy_pytree(result.params),
                infos=infos,
                manager=manager,
                psnr_db=float(result.psnr_db),
                rate_latent_bpp=float(result.rate_latent_bpp),
                decoded=decoded,
                frame_bytes=frame_bytes,
                stats=result.stats,
            )
            if verbose:
                print(f"frame {frame.display_order:>3} ({frame.frame_type}, depth {frame.depth}): "
                      f"psnr {float(result.psnr_db):6.2f} dB, "
                      f"{float(result.rate_latent_bpp):.4f} bpp, lmbda {lmbda:.2e}")
            if workdir is not None:
                self.save(Path(workdir) / "video_encoder.pkl")
            if is_job_over(start_time, job_duration_min):
                return TrainingExitCode.REQUEUE
        return TrainingExitCode.END

    def frame_cfg(self, frame_type: str) -> CoolChicConfig:
        """The architecture of a frame type: P / B frames synthesize 6 / 9
        channels (residue, flows, gains)."""
        return dataclasses.replace(self.cfg, frame_type=frame_type,
                                   out_channels={"I": 3, "P": 6, "B": 9}[frame_type])

    def _refs_for(self, frame: Frame) -> List[np.ndarray]:
        """The decoded reference frames of ``frame``, earliest first."""
        refs = []
        for disp in frame.index_references:
            ref_frame = self.coding_structure.get_frame_from_display_order(disp)
            enc = self.all_frame_encoders.get(str(ref_frame.coding_order))
            if enc is None or enc.decoded is None:
                raise RuntimeError(f"reference frame (display {disp}) not yet encoded")
            refs.append(enc.decoded)
        return refs

    def _gop_header(self) -> GopHeader:
        return GopHeader(
            img_size=self.cfg.img_size,
            frame_data_type=self.frame_data_type,
            bitdepth=self.bitdepth,
            intra_period=self.coding_structure.intra_period,
            p_period=self.coding_structure.p_period,
        )

    def _write_frame(self, params, infos, frame: Frame, hls_sig_blksize: int) -> bytes:
        cfg_f = self.frame_cfg(frame.frame_type)
        q_step, expgol = _writer_choices(infos)
        frame_bytes, _, _ = encode_frame_bitstream(
            params, cfg_f, q_step, expgol, display_index=frame.display_order,
            hls_sig_blksize=hls_sig_blksize,
            flow_gain=0 if frame.frame_type == "I" else cfg_f.flow_gain)
        return bytes(frame_bytes)

    def _integer_reconstruct(
        self, params, infos, frame: Frame, cfg_f: CoolChicConfig,
        stats: Optional[EncodeStats] = None,
    ) -> Tuple[np.ndarray, bytes]:
        """Write this frame's stream and decode it through the integer
        pipeline, as ``bitstream/decode.py::decode_video_bitstream`` does in
        its frame loop: the 12-frac synthesis output, the fixed-point warp
        against the stored references, the output quantization, the 4:2:0
        chroma repeat. Returns (the float [3, H, W] frame a decoder
        reconstructs, the frame's bytes); ``stats`` gets the host seconds of
        the write and of the decode, its spans ``write.frame`` and
        ``decode.int`` (``utils/trace.py``)."""
        with span("write.frame") as write:
            frame_bytes = self._write_frame(params, infos, frame, RECONSTRUCT_HLS_SIG_BLKSIZE)
        with span("decode.int") as decode:
            gop = self._gop_header()
            raw12, finfo, _ = _decode_frame_raw12(frame_bytes, 0, gop)
            max_dyn = (1 << self.bitdepth) - 1

            if raw12.shape[0] == 3:
                f444 = raw12[:3]
            else:
                # The references as the decoder stores them, and its search for
                # the nearest earlier (and later) display index.
                stored: Dict[int, np.ndarray] = {}
                for k, enc in self.all_frame_encoders.items():
                    fr = self.coding_structure.get_frame_from_coding_order(int(k))
                    vq = np.round(np.asarray(enc.decoded, np.float64) * max_dyn).astype(np.int64)
                    stored[fr.display_order] = (vq << PREC) // max_dyn
                disp = frame.display_order
                ref_prev = next((stored[i] for i in range(disp - 1, -1, -1) if i in stored), None)
                ref_next = None
                if raw12.shape[0] == 9:
                    ref_next = next((stored[i] for i in range(disp + 1, gop.intra_period + 1)
                                     if i in stored), None)
                f444 = process_inter_int(raw12, ref_prev, ref_next, finfo["frame_header"].flow_gain)

            vq = np.clip((f444.astype(np.int64) * max_dyn + HALF) >> PREC, 0, max_dyn)
            if self.frame_data_type == "yuv420":
                u = np.repeat(np.repeat(vq[1, ::2, ::2], 2, 0), 2, 1)
                v = np.repeat(np.repeat(vq[2, ::2, ::2], 2, 0), 2, 1)
                vq = np.stack([vq[0], u, v])
        if stats is not None:
            stats.stage_seconds["write"] = 1e-9 * write.ns
            stats.stage_seconds["integer_decode"] = 1e-9 * decode.ns
        return vq.astype(np.float32) / np.float32(max_dyn), frame_bytes

    def to_bitstream(self, hls_sig_blksize: int = 16) -> bytes:
        """The GOP header and every frame's stream, in coding order. A frame
        written to reconstruct it at this ``hls_sig_blksize`` is not written
        again: the writer is a function of the same inputs."""
        out = write_gop_header(self._gop_header())
        for idx in range(self.coding_structure.get_number_of_frames()):
            enc = self.all_frame_encoders[str(idx)]
            if enc.infos is None:
                raise ValueError(f"frame {idx} was trained without NN quantization; cannot write "
                                 "a bitstream (use a preset with quantize_model)")
            if enc.frame_bytes is not None and hls_sig_blksize == RECONSTRUCT_HLS_SIG_BLKSIZE:
                out += enc.frame_bytes
            else:
                frame = self.coding_structure.get_frame_from_coding_order(idx)
                out += self._write_frame(enc.params, enc.infos, frame, hls_sig_blksize)
        return out

    def save(self, path: Path) -> None:
        """Pickle the whole state (numpy arrays only)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        state = {
            "coding_structure": self.coding_structure,
            "cfg": self.cfg,
            "preset": self.preset,
            "lmbda": self.lmbda,
            "n_loops": self.n_loops,
            "bitdepth": self.bitdepth,
            "frame_data_type": self.frame_data_type,
            "all_frame_encoders": self.all_frame_encoders,
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)


def load_video_encoder(path: Path, device: str | torch.device = "cuda") -> VideoEncoder:
    """A ``VideoEncoder`` from ``save``'s file, to go on encoding on ``device``."""
    with open(path, "rb") as f:
        state = pickle.load(f)
    enc = VideoEncoder(
        coding_structure=state["coding_structure"],
        cfg=state["cfg"],
        preset=state["preset"],
        lmbda=state["lmbda"],
        n_loops=state["n_loops"],
        device=device,
    )
    enc.bitdepth = state["bitdepth"]
    enc.frame_data_type = state["frame_data_type"]
    enc.all_frame_encoders = state["all_frame_encoders"]
    return enc
